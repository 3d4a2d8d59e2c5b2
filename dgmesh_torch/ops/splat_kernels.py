"""Gaussian splat tile compositing: the CUDA kernel's wrapper and its plain twin.

Counterpart of dgmesh_tpu/ops/splat_pallas.py (forward).  ``composite_tiles``
launches ``csrc/composite.cu`` for a CUDA tensor and runs the plain PyTorch
twin ``composite_tiles_ref`` only for a CPU tensor; there is no fallback.

Layout (T,K,16) float32 per tile row: 0,1 mean2d | 2-4 conic | 5 opacity |
6-8 rgb | 9 valid | 10-15 padding.  Outputs rgb (T,P,3) and alpha (T,P),
P = tile_h·tile_w, with no background term.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LANES = 16


def tile_pixels(T: int, tiles_x: int, tile_h: int, tile_w: int, offset: float,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres (T,P) of every tile, row-major within the tile."""
    t = torch.arange(T, device=device)
    p = torch.arange(tile_h * tile_w, device=device)
    px = ((t % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    py = ((t // tiles_x) * tile_h)[:, None] + (p // tile_w)[None, :]
    return px.float() + offset, py.float() + offset


def composite_tiles_ref(attrs: torch.Tensor, tiles_x: int, tile_h: int,
                        tile_w: int, chunk: int = 64):
    """Plain PyTorch twin of the kernel, after ``_composite_ref``
    (dgmesh_tpu/ops/splat_pallas.py:229-261), chunked over tiles."""
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    rgb = attrs.new_empty((T, P, 3))
    alpha = attrs.new_empty((T, P))
    px_all, py_all = tile_pixels(T, tiles_x, tile_h, tile_w, 0.0, attrs.device)
    for s in range(0, T, chunk):
        at = attrs[s:s + chunk]                             # (C,K,16)
        dx = at[..., 0:1] - px_all[s:s + chunk, None, :]    # (C,K,P)
        dy = at[..., 1:2] - py_all[s:s + chunk, None, :]
        power = -0.5 * (at[..., 2:3] * dx * dx + at[..., 4:5] * dy * dy) - at[..., 3:4] * dx * dy
        al = torch.clamp_max(at[..., 5:6] * torch.exp(power), ALPHA_MAX)
        ok = (at[..., 9:10] > 0.5) & (power <= 0.0) & (al >= ALPHA_MIN)
        al = torch.where(ok, al, 0.0)
        log1m = torch.log1p(-al)
        csum = torch.cumsum(log1m, dim=1)
        w = al * torch.exp(csum - log1m)
        rgb[s:s + chunk] = torch.einsum("ckp,ckd->cpd", w, at[..., 6:9])
        alpha[s:s + chunk] = 1.0 - torch.exp(csum[:, -1, :])
    return rgb, alpha


def composite_tiles(attrs: torch.Tensor, tiles_x: int, tile_h: int, tile_w: int):
    """attrs (T,K,16) f32 → rgb (T,P,3), alpha (T,P).

    A CUDA tensor goes to the kernel (``composite_tiles.launches`` counts
    each launch); a CPU tensor takes the plain twin."""
    if attrs.dim() != 3 or attrs.shape[-1] != LANES:
        raise ValueError(f"attrs must be (T,K,{LANES}), got {tuple(attrs.shape)}")
    if attrs.dtype != torch.float32:
        raise TypeError(f"attrs must be float32, got {attrs.dtype}")
    if attrs.device.type == "cpu":
        return composite_tiles_ref(attrs, tiles_x, tile_h, tile_w)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_tiles runs on cuda or cpu, not {attrs.device}")
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    if K == 0 or not 0 < P <= 1024:
        raise ValueError(f"composite_tiles needs K > 0 and 0 < P <= 1024 (K={K}, P={P})")
    if not attrs.is_contiguous():
        raise ValueError("attrs must be contiguous")
    rgb = torch.empty((T, P, 3), dtype=torch.float32, device=attrs.device)
    alpha = torch.empty((T, P), dtype=torch.float32, device=attrs.device)
    lib = cuda_build.library("composite")
    fn = lib.composite_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), rgb.data_ptr(), alpha.data_ptr(),
                 T, K, tiles_x, tile_h, tile_w, stream)
    cuda_build.check(err, "composite_tiles")
    composite_tiles.launches += 1
    return rgb, alpha


composite_tiles.launches = 0
