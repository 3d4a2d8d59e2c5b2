"""Mesh tile shading: the CUDA kernel's wrapper and its plain twin.

Counterpart of dgmesh_tpu/ops/mesh_raster_pallas.py (forward).
``shade_tiles`` launches ``csrc/shade.cu`` for a CUDA tensor and runs the
plain PyTorch twin ``shade_tiles_ref`` only for a CPU tensor; there is no
fallback.

Layout (T,K,24) float32 per tile row: 0-5 screen triangle | 6-8 clip 1/w |
9 valid | 10-18 corner colours | 19 face id | 20-23 padding.  Outputs rgb
(T,P,3), hard (T,P), soft (T,P) and fid (T,P), with no background term.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .splat_kernels import tile_pixels

AREA_MIN = 1e-4
NEG = -3.0e38
LANES = 24


def shade_tiles_ref(attrs: torch.Tensor, tiles_x: int, tile_h: int, tile_w: int,
                    sigma: float, chunk: int = 64):
    """Plain PyTorch twin of the kernel.

    Follows ``_shade_kernel`` (dgmesh_tpu/ops/mesh_raster_pallas.py:40-134)
    operation by operation, as ``_shade_ref`` (:384) does: the same edge
    functions, ``AREA_MIN`` gate, first-max winner, ``max(Σpw, 1e-12)``
    normalisation and clipped edge distance.  Chunked over tiles."""
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    dev = attrs.device
    rgb = attrs.new_empty((T, P, 3))
    hard = attrs.new_empty((T, P))
    soft = attrs.new_empty((T, P))
    fid = attrs.new_empty((T, P))
    px_all, py_all = tile_pixels(T, tiles_x, tile_h, tile_w, 0.5, dev)
    for s in range(0, T, chunk):
        a = attrs[s:s + chunk]                                  # (C,K,24)
        px = px_all[s:s + chunk, None, :]                       # (C,1,P)
        py = py_all[s:s + chunk, None, :]
        ax, ay, bx, by, cx, cy = (a[..., i:i + 1] for i in range(6))
        iw0, iw1, iw2 = a[..., 6:7], a[..., 7:8], a[..., 8:9]
        valid = a[..., 9:10] > 0.5
        e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)      # (C,K,P)
        e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)    # (C,K,1)
        live = area.abs() >= AREA_MIN
        area = torch.where(live, area, 1.0)
        b0, b1, b2 = e0 / area, e1 / area, e2 / area
        inside = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0) & valid & live
        zi = b0 * iw0 + b1 * iw1 + b2 * iw2
        zkey = torch.where(inside, zi, NEG)
        win = torch.argmax(zkey, dim=1, keepdim=True)           # first max
        has_win = torch.gather(inside, 1, win)[:, 0]            # (C,P)
        pick = lambda x: torch.gather(x.expand(-1, -1, P), 1, win)[:, 0]
        pw0 = pick(b0) * pick(iw0)
        pw1 = pick(b1) * pick(iw1)
        pw2 = pick(b2) * pick(iw2)
        norm = torch.clamp_min(pw0 + pw1 + pw2, 1e-12)
        pw0, pw1, pw2 = pw0 / norm, pw1 / norm, pw2 / norm
        cols = torch.stack([pick(a[..., i:i + 1]) for i in range(10, 20)], -1)  # (C,P,10)
        out = (pw0[..., None] * cols[..., 0:3] + pw1[..., None] * cols[..., 3:6]
               + pw2[..., None] * cols[..., 6:9])
        rgb[s:s + chunk] = torch.where(has_win[..., None], out, 0.0)
        fid[s:s + chunk] = torch.where(has_win, cols[..., 9], 0.0)
        hard[s:s + chunk] = inside.any(dim=1).float()

        d2min = None
        for vx0, vy0, vx1, vy1 in ((ax, ay, bx, by), (bx, by, cx, cy), (cx, cy, ax, ay)):
            ex, ey = vx1 - vx0, vy1 - vy0
            qx, qy = px - vx0, py - vy0
            t = torch.clamp((qx * ex + qy * ey) / torch.clamp_min(ex * ex + ey * ey, 1e-12),
                            0.0, 1.0)
            dx, dy = qx - t * ex, qy - t * ey
            d2 = dx * dx + dy * dy
            d2min = d2 if d2min is None else torch.minimum(d2min, d2)
        d = torch.sqrt(d2min + 1e-12)
        signed = torch.where(inside, -d, d)
        sg = torch.where(valid, torch.sigmoid(-signed / sigma), 0.0)
        log_keep = torch.log1p(-torch.clamp(sg, 0.0, 1.0 - 1e-6))
        soft[s:s + chunk] = 1.0 - torch.exp(log_keep.sum(dim=1))
    return rgb, hard, soft, fid


def shade_tiles(attrs: torch.Tensor, tiles_x: int, tile_h: int, tile_w: int,
                sigma: float):
    """attrs (T,K,24) f32 → rgb (T,P,3), hard, soft, fid (T,P).

    A CUDA tensor goes to the kernel (``shade_tiles.launches`` counts each
    launch); a CPU tensor takes the plain twin."""
    if attrs.dim() != 3 or attrs.shape[-1] != LANES:
        raise ValueError(f"attrs must be (T,K,{LANES}), got {tuple(attrs.shape)}")
    if attrs.dtype != torch.float32:
        raise TypeError(f"attrs must be float32, got {attrs.dtype}")
    if attrs.device.type == "cpu":
        return shade_tiles_ref(attrs, tiles_x, tile_h, tile_w, sigma)
    if attrs.device.type != "cuda":
        raise ValueError(f"shade_tiles runs on cuda or cpu, not {attrs.device}")
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    if K == 0 or not 0 < P <= 1024:
        raise ValueError(f"shade_tiles needs K > 0 and 0 < P <= 1024 (K={K}, P={P})")
    if not attrs.is_contiguous():
        raise ValueError("attrs must be contiguous")
    f32 = dict(dtype=torch.float32, device=attrs.device)
    rgb = torch.empty((T, P, 3), **f32)
    hard = torch.empty((T, P), **f32)
    soft = torch.empty((T, P), **f32)
    fid = torch.empty((T, P), **f32)
    lib = cuda_build.library("shade")
    fn = lib.shade_tiles_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), rgb.data_ptr(), hard.data_ptr(), soft.data_ptr(),
                 fid.data_ptr(), T, K, tiles_x, tile_h, tile_w, float(sigma), stream)
    cuda_build.check(err, "shade_tiles")
    shade_tiles.launches += 1
    return rgb, hard, soft, fid


shade_tiles.launches = 0
