"""Mesh tile shading: the CUDA kernels' wrappers and their plain twins.

Counterpart of dgmesh_tpu/ops/mesh_raster_pallas.py.  ``shade_tiles``
launches ``csrc/shade.cu`` (forward) and ``shade_bwd`` launches
``csrc/shade_bwd.cu`` (its analytic backward through rgb and soft) for a
CUDA tensor; each runs its plain PyTorch twin (``shade_tiles_ref``,
``shade_bwd_ref``) only for a CPU tensor; there is no fallback.
``ShadeTiles`` pairs the two as one ``torch.autograd.Function``: in
training the forward also leaves each pixel's winner row and soft sum M
(the residuals), so the backward does not walk the rows again.

Layout (T,K,24) float32 per tile row: 0-5 screen triangle | 6-8 clip 1/w |
9 valid | 10-18 corner colours | 19 face id | 20-23 padding.  Outputs rgb
(T,P,3), hard (T,P), soft (T,P) and fid (T,P), with no background term;
residuals win (T,P) int32 (the winner's row in its tile, -1 where none) and
M (T,P) float32 (soft = 1 - exp(M)).  Row t of the arrays is tile
``tile0 + t`` of the image (``tile0`` 0 by default), as in
ops/splat_kernels.py.
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
                    sigma: float, chunk: int = 64, residuals: bool = False,
                    tile0: int = 0):
    """Plain PyTorch twin of the kernel.

    Follows ``_shade_kernel`` (dgmesh_tpu/ops/mesh_raster_pallas.py:40-134)
    operation by operation, as ``_shade_ref`` (:384) does: the same edge
    functions, ``AREA_MIN`` gate, first-max winner, ``max(Σpw, 1e-12)``
    normalisation and clipped edge distance.  Chunked over tiles.  With
    ``residuals``, win and M follow the four outputs."""
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    dev = attrs.device
    rgb = attrs.new_empty((T, P, 3))
    hard = attrs.new_empty((T, P))
    soft = attrs.new_empty((T, P))
    fid = attrs.new_empty((T, P))
    win_res = torch.empty((T, P), dtype=torch.int32, device=dev)
    m_res = attrs.new_empty((T, P))
    px_all, py_all = tile_pixels(T, tiles_x, tile_h, tile_w, 0.5, dev, tile0)
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
        win_res[s:s + chunk] = torch.where(has_win, win[:, 0], -1)

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
        m_res[s:s + chunk] = log_keep.sum(dim=1)
        soft[s:s + chunk] = 1.0 - torch.exp(m_res[s:s + chunk])
    return (rgb, hard, soft, fid) + ((win_res, m_res) if residuals else ())


def shade_tiles(attrs: torch.Tensor, tiles_x: int, tile_h: int, tile_w: int,
                sigma: float, residuals: bool = False, tile0: int = 0):
    """attrs (T,K,24) f32 → rgb (T,P,3), hard, soft, fid (T,P), and with
    ``residuals`` the backward's win (T,P) int32 and M (T,P) f32.

    A CUDA tensor goes to the kernel (``shade_tiles.launches`` counts each
    launch); a CPU tensor takes the plain twin."""
    cuda_build.check_rows(attrs, LANES, "shade_tiles")
    if attrs.device.type == "cpu":
        return shade_tiles_ref(attrs, tiles_x, tile_h, tile_w, sigma, residuals=residuals,
                               tile0=tile0)
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    cuda_build.check_launch(K, P, "shade_tiles", attrs)
    if attrs.data_ptr() % 16:
        raise ValueError("shade_tiles: attrs must be 16-byte aligned (its rows are read as float4)")
    f32 = dict(dtype=torch.float32, device=attrs.device)
    rgb = torch.empty((T, P, 3), **f32)
    hard = torch.empty((T, P), **f32)
    soft = torch.empty((T, P), **f32)
    fid = torch.empty((T, P), **f32)
    res = ((torch.empty((T, P), dtype=torch.int32, device=attrs.device),
            torch.empty((T, P), **f32)) if residuals else ())
    lib = cuda_build.library("shade")
    fn = lib.shade_tiles_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), rgb.data_ptr(), hard.data_ptr(), soft.data_ptr(),
                 fid.data_ptr(), *([x.data_ptr() for x in res] if res else [None, None]),
                 T, K, tiles_x, tile_h, tile_w, tile0, float(sigma), stream)
    cuda_build.check(err, "shade_tiles")
    shade_tiles.launches += 1
    return (rgb, hard, soft, fid) + res


shade_tiles.launches = 0


def _half_split(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Share of ``a`` in the gradient of ``minimum(a, b)``: 1 where a < b,
    0.5 at an exact tie, 0 where a > b (``jnp.minimum``'s split)."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0))


def shade_bwd_ref(attrs: torch.Tensor, g_rgb: torch.Tensor, g_soft: torch.Tensor,
                  tiles_x: int, tile_h: int, tile_w: int, sigma: float,
                  chunk: int = 16, win=None, M=None, tile0: int = 0):
    """Plain PyTorch twin of the backward kernel, after ``_shade_bwd_kernel``
    (dgmesh_tpu/ops/mesh_raster_pallas.py:164-357), chunked over tiles.

    Gradients reach attrs through rgb and soft only.  The gates are the
    Pallas kernel's: the winner and ``inside`` carry none; ``AREA_MIN``
    zeroes the barycentric branch; the normaliser is gated by S ≥ 1e-12; the
    edge clip weights ``tg`` are 1 inside (0, 1), 0.5 at uu = 0 or 1 and 0
    outside; the nearest-edge ``picks`` split 0.5/0.5 at exact d² ties; the
    soft term is gated by s ≤ 1 − 1e-6.  Rows that are not valid get exactly
    zero; lanes 9 and 19-23 are zero.  Given the forward's residuals ``win``
    and ``M`` (``shade_tiles_ref(..., residuals=True)``), the winner and the
    soft sum are taken from them, with the same result bit for bit.

    The rgb path's terms of a (row, pixel) pair are selected where the row
    wins the pixel (``torch.where``, not a product with the one-hot): a NaN
    in one row's corners or colours then reaches only that row's gradients
    and the pixels it wins, as in the kernel.  (The Pallas kernel's dense
    one-hot sums spread it over the tile through 0·NaN.)"""
    T, K, _ = attrs.shape
    d_attrs = attrs.new_zeros((T, K, LANES))
    px_all, py_all = tile_pixels(T, tiles_x, tile_h, tile_w, 0.5, attrs.device, tile0)
    for s in range(0, T, chunk):
        a = attrs[s:s + chunk]                                  # (C,K,24)
        px = px_all[s:s + chunk, None, :]                       # (C,1,P)
        py = py_all[s:s + chunk, None, :]
        g = g_rgb[s:s + chunk]                                  # (C,P,3)
        gs = g_soft[s:s + chunk, None, :]                       # (C,1,P)
        ax, ay, bx, by, cx, cy = (a[..., i:i + 1] for i in range(6))
        iw = [a[..., 6 + j:7 + j] for j in range(3)]
        valid = a[..., 9:10] > 0.5

        # ---- the forward's selection, recomputed
        e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)      # (C,K,P)
        e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        area_raw = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        area_live = area_raw.abs() >= AREA_MIN
        area = torch.where(area_live, area_raw, 1.0)
        b = [e0 / area, e1 / area, e2 / area]
        inside = (b[0] >= 0.0) & (b[1] >= 0.0) & (b[2] >= 0.0) & valid & area_live
        if win is None:
            zi = b[0] * iw[0] + b[1] * iw[1] + b[2] * iw[2]
            zkey = torch.where(inside, zi, NEG)
            winslot = torch.argmax(zkey, dim=1, keepdim=True)   # (C,1,P) first max
            has_win = torch.gather(inside, 1, winslot)          # (C,1,P)
        else:
            w_res = win[s:s + chunk, None, :].long()
            winslot, has_win = w_res.clamp_min(0), w_res >= 0
        wins = torch.zeros_like(b[0], dtype=torch.bool).scatter_(1, winslot, True) & has_win
        win_1h = wins.float()

        def pick(x):                                            # winner's value (C,1,P)
            return torch.where(has_win, torch.gather(x.expand(-1, -1, b[0].shape[-1]), 1,
                                                     winslot), 0.0)

        bw = [pick(bj) for bj in b]
        ww = [pick(w) for w in iw]
        q = [bw[j] * ww[j] for j in range(3)]
        S_raw = q[0] + q[1] + q[2]
        S_live = (S_raw >= 1e-12).float()
        S = torch.clamp_min(S_raw, 1e-12)
        pw = [qj / S for qj in q]

        # ---- rgb path
        d = d_attrs[s:s + chunk]
        u = []
        for j in range(3):
            col = a[..., 10 + 3 * j:13 + 3 * j]                 # (C,K,3)
            d[..., 10 + 3 * j:13 + 3 * j] = torch.einsum("ckp,cpd->ckd", win_1h * pw[j], g)
            u.append(torch.where(wins, torch.einsum("ckd,cpd->ckp", col, g), 0.0)
                     .sum(1, keepdim=True))
        ubar = pw[0] * u[0] + pw[1] * u[1] + pw[2] * u[2]
        dq = [(u[j] - ubar) / S * S_live for j in range(3)]
        for j in range(3):
            d[..., 6 + j] = torch.where(wins, dq[j] * bw[j], 0.0).sum(-1)
        alive = area_live.float()
        de = [torch.where(wins, dq[j] * ww[j], 0.0) / area * alive for j in range(3)]
        d_area = torch.where(wins, -(de[0] * b[0] + de[1] * b[1] + de[2] * b[2]), 0.0)
        # e0: v0=b v1=c; e1: v0=c v1=a; e2: v0=a v1=b
        d_ax = de[1] * (py - cy) + de[2] * (by - py)
        d_ay = de[1] * (cx - px) + de[2] * (px - bx)
        d_bx = de[2] * (py - ay) + de[0] * (cy - py)
        d_by = de[2] * (ax - px) + de[0] * (px - cx)
        d_cx = de[0] * (py - by) + de[1] * (ay - py)
        d_cy = de[0] * (bx - px) + de[1] * (px - ax)
        dA = d_area.sum(-1, keepdim=True)                       # (C,K,1)
        face = [dA * (by - cy), dA * (cx - bx), dA * (cy - ay),
                dA * (ax - cx), dA * (-(by - ay)), dA * (bx - ax)]

        # ---- soft path
        edges = ((ax, ay, bx, by), (bx, by, cx, cy), (cx, cy, ax, ay))
        geo = []
        for vx0, vy0, vx1, vy1 in edges:
            ex, ey = vx1 - vx0, vy1 - vy0
            qx, qy = px - vx0, py - vy0
            h_raw = ex * ex + ey * ey
            h = torch.clamp_min(h_raw, 1e-12)
            uu = (qx * ex + qy * ey) / h
            t = torch.clamp(uu, 0.0, 1.0)
            dx, dy = qx - t * ex, qy - t * ey
            tg = torch.where((uu > 0.0) & (uu < 1.0), 1.0,
                             torch.where((uu == 0.0) | (uu == 1.0), 0.5, 0.0))
            geo.append((dx * dx + dy * dy, t, qx, qy, ex, ey, h, uu, tg,
                        (h_raw >= 1e-12).float()))
        d2 = [x[0] for x in geo]
        m01 = torch.minimum(d2[0], d2[1])
        d2min = torch.minimum(m01, d2[2])
        w0a = _half_split(d2[0], d2[1])
        wm = _half_split(m01, d2[2])
        picks = [w0a * wm, (1.0 - w0a) * wm, 1.0 - wm]
        dist = torch.sqrt(d2min + 1e-12)
        signed = torch.where(inside, -dist, dist)
        sg = torch.where(valid, torch.sigmoid(-signed / sigma), 0.0)
        sc_live = ((sg <= 1.0 - 1e-6) & valid).float()
        log_keep = torch.log1p(-torch.clamp(sg, 0.0, 1.0 - 1e-6))
        m = (log_keep.sum(1, keepdim=True) if M is None         # (C,1,P)
             else M[s:s + chunk, None, :])
        d_signed = (-gs * torch.exp(m) / sigma) * sg * sc_live
        d_dist = torch.where(inside, -d_signed, d_signed)
        d_d2min = d_dist / (2.0 * dist)
        dv = [[d_ax, d_ay], [d_bx, d_by], [d_cx, d_cy]]
        for j, (_, t, qx, qy, ex, ey, h, uu, tg, hl) in enumerate(geo):
            d_d2 = d_d2min * picks[j]
            dx, dy = qx - t * ex, qy - t * ey
            g2x, g2y = d_d2 * 2.0 * dx, d_d2 * 2.0 * dy
            dt = -(g2x * ex + g2y * ey)
            d_qx = g2x + dt * tg * ex / h
            d_qy = g2y + dt * tg * ey / h
            d_ex = -t * g2x + dt * tg * (qx - 2.0 * ex * uu) * hl / h
            d_ey = -t * g2y + dt * tg * (qy - 2.0 * ey * uu) * hl / h
            v0, v1 = j, (j + 1) % 3                             # edge v0 → v1
            dv[v0][0] = dv[v0][0] + (-d_qx - d_ex)
            dv[v0][1] = dv[v0][1] + (-d_qy - d_ey)
            dv[v1][0] = dv[v1][0] + d_ex
            dv[v1][1] = dv[v1][1] + d_ey
        for i in range(6):
            d[..., i] = dv[i // 2][i % 2].sum(-1) + face[i][..., 0]
        # invalid rows: exactly 0, whatever a NaN elsewhere in the tile
        d.masked_fill_(~valid, 0.0)
    return d_attrs


def shade_bwd(attrs: torch.Tensor, g_rgb: torch.Tensor, g_soft: torch.Tensor,
              tiles_x: int, tile_h: int, tile_w: int, sigma: float,
              win=None, M=None, tile0: int = 0) -> torch.Tensor:
    """attrs (T,K,24), g_rgb (T,P,3), g_soft (T,P) f32 → d_attrs (T,K,24);
    optionally given the forward's residuals win (T,P) int32 and M (T,P)
    f32 (``shade_tiles(..., residuals=True)``), so the kernel walks no rows
    for the winner and the soft sum.

    A CUDA tensor goes to the kernel (``shade_bwd.launches`` counts each
    launch); a CPU tensor takes the plain twin."""
    cuda_build.check_rows(attrs, LANES, "shade_bwd")
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    if tuple(g_rgb.shape) != (T, P, 3) or tuple(g_soft.shape) != (T, P):
        raise ValueError(f"cotangents must be (T,P,3) and (T,P), got "
                         f"{tuple(g_rgb.shape)} and {tuple(g_soft.shape)}")
    if g_rgb.dtype != torch.float32 or g_soft.dtype != torch.float32:
        raise TypeError("cotangents must be float32")
    if (win is None) != (M is None):
        raise ValueError("shade_bwd takes both residuals win and M, or neither")
    if win is not None and (tuple(win.shape) != (T, P) or tuple(M.shape) != (T, P)
                            or win.dtype != torch.int32 or M.dtype != torch.float32):
        raise ValueError("residuals must be win (T,P) int32 and M (T,P) float32")
    if attrs.device.type == "cpu":
        return shade_bwd_ref(attrs, g_rgb, g_soft, tiles_x, tile_h, tile_w, sigma,
                             win=win, M=M, tile0=tile0)
    res = () if win is None else (win, M)
    cuda_build.check_launch(K, P, "shade_bwd", attrs, g_rgb, g_soft, *res, whole_warps=True)
    d_attrs = torch.empty((T, K, LANES), dtype=torch.float32, device=attrs.device)
    lib = cuda_build.library("shade_bwd")
    fn = lib.shade_bwd_res_launch if res else lib.shade_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * (4 + len(res)) + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), g_rgb.data_ptr(), g_soft.data_ptr(),
                 *(x.data_ptr() for x in res), d_attrs.data_ptr(),
                 T, K, tiles_x, tile_h, tile_w, tile0, float(sigma), stream)
    cuda_build.check(err, "shade_bwd")
    shade_bwd.launches += 1
    return d_attrs


shade_bwd.launches = 0


class ShadeTiles(torch.autograd.Function):
    """Forward kernel 3, backward kernel 4; gradients reach ``attrs`` through
    rgb and soft only (hard coverage and the face id are step functions), as
    JAX's ``make_shade_tiles`` custom_vjp
    (dgmesh_tpu/ops/mesh_raster_pallas.py:453-486).  Where attrs needs a
    gradient, the forward's residuals (winner rows and soft sums, 8 bytes a
    pixel) are saved for the backward; a render writes none."""

    @staticmethod
    def forward(ctx, attrs, tiles_x: int, tile_h: int, tile_w: int, sigma: float,
                tile0: int = 0):
        ctx.geo = (tiles_x, tile_h, tile_w, sigma)
        ctx.tile0 = tile0
        rgb, hard, soft, fid, *res = shade_tiles(attrs, tiles_x, tile_h, tile_w, sigma,
                                                 residuals=ctx.needs_input_grad[0],
                                                 tile0=tile0)
        ctx.save_for_backward(attrs, *res)
        ctx.mark_non_differentiable(hard, fid)
        return rgb, hard, soft, fid

    @staticmethod
    def backward(ctx, g_rgb, g_hard, g_soft, g_fid):
        attrs, win, M = ctx.saved_tensors
        d = shade_bwd(attrs, g_rgb.contiguous(), g_soft.contiguous(), *ctx.geo, win, M,
                      tile0=ctx.tile0)
        return d, None, None, None, None, None
