"""Gaussian splat tile compositing: the CUDA kernels' wrappers and their plain twins.

Counterpart of dgmesh_tpu/ops/splat_pallas.py.  ``composite_tiles`` launches
``csrc/composite.cu`` (forward) and ``composite_bwd`` launches
``csrc/composite_bwd.cu`` (its analytic backward) for a CUDA tensor; each
runs its plain PyTorch twin (``composite_tiles_ref``, ``composite_bwd_ref``)
only for a CPU tensor; there is no fallback.  ``CompositeTiles`` pairs the
two as one ``torch.autograd.Function``: in training the forward also leaves
each pixel's log-transmittance S (the residual), and the backward takes
T_fin = e^S and the pixel's total Σ_k u_k w_k = g_rgb·rgb from S and the
rgb output instead of walking the rows once more.

Layout (T,K,16) float32 per tile row: 0,1 mean2d | 2-4 conic | 5 opacity |
6-8 rgb | 9 valid | 10-15 padding.  Outputs rgb (T,P,3) and alpha (T,P),
P = tile_h·tile_w, with no background term; residual S (T,P) float32
(alpha = 1 − e^S).  Row t of the arrays is tile ``tile0 + t`` of the image
(``tile0`` 0 by default): a rank of the multi-device step composites its
own block of tiles (parallel/sharded_splat.py).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import tracing
from . import cuda_build

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
LANES = 16


def tile_pixels(T: int, tiles_x: int, tile_h: int, tile_w: int, offset: float,
                device, tile0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres (T,P) of tiles tile0 … tile0 + T − 1, row-major within
    the tile."""
    t = torch.arange(tile0, tile0 + T, device=device)
    p = torch.arange(tile_h * tile_w, device=device)
    px = ((t % tiles_x) * tile_w)[:, None] + (p % tile_w)[None, :]
    py = ((t // tiles_x) * tile_h)[:, None] + (p // tile_w)[None, :]
    return px.float() + offset, py.float() + offset


def composite_tiles_ref(attrs: torch.Tensor, tiles_x: int, tile_h: int,
                        tile_w: int, chunk: int = 64, residuals: bool = False,
                        tile0: int = 0):
    """Plain PyTorch twin of the kernel, after ``_composite_ref``
    (dgmesh_tpu/ops/splat_pallas.py:229-261), chunked over tiles.  With
    ``residuals``, S follows rgb and alpha."""
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    rgb = attrs.new_empty((T, P, 3))
    alpha = attrs.new_empty((T, P))
    s_res = attrs.new_empty((T, P))
    px_all, py_all = tile_pixels(T, tiles_x, tile_h, tile_w, 0.0, attrs.device, tile0)
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
        s_res[s:s + chunk] = csum[:, -1, :]
        alpha[s:s + chunk] = 1.0 - torch.exp(s_res[s:s + chunk])
    return (rgb, alpha) + ((s_res,) if residuals else ())


def composite_tiles(attrs: torch.Tensor, tiles_x: int, tile_h: int, tile_w: int,
                    residuals: bool = False, tile0: int = 0):
    """attrs (T,K,16) f32 → rgb (T,P,3), alpha (T,P), and with ``residuals``
    the backward's S (T,P) f32.

    A CUDA tensor goes to the kernel (``composite_tiles.launches`` counts
    each launch); a CPU tensor takes the plain twin."""
    cuda_build.check_rows(attrs, LANES, "composite_tiles")
    if attrs.device.type == "cpu":
        return composite_tiles_ref(attrs, tiles_x, tile_h, tile_w, residuals=residuals,
                                   tile0=tile0)
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    cuda_build.check_launch(K, P, "composite_tiles", attrs)
    if attrs.data_ptr() % 16:
        raise ValueError("composite_tiles: attrs must be 16-byte aligned (its rows are read "
                         "as float4)")
    f32 = dict(dtype=torch.float32, device=attrs.device)
    rgb = torch.empty((T, P, 3), **f32)
    alpha = torch.empty((T, P), **f32)
    res = (torch.empty((T, P), **f32),) if residuals else ()
    lib = cuda_build.library("composite")
    fn = lib.composite_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), rgb.data_ptr(), alpha.data_ptr(),
                 res[0].data_ptr() if res else None, T, K, tiles_x, tile_h, tile_w, tile0,
                 stream)
    cuda_build.check(err, "composite_tiles")
    composite_tiles.launches += 1
    return (rgb, alpha) + res


composite_tiles.launches = 0


def composite_bwd_ref(attrs: torch.Tensor, g_rgb: torch.Tensor, g_alpha: torch.Tensor,
                      tiles_x: int, tile_h: int, tile_w: int, chunk: int = 64,
                      rgb=None, S=None, tile0: int = 0):
    """Plain PyTorch twin of the backward kernel, after ``_composite_bwd_kernel``
    (dgmesh_tpu/ops/splat_pallas.py:116-202), chunked over tiles.

    Recomputes the forward, then
      dc_i = Σ_p w_i g_rgb,
      dα_i = u_i T_i − (suffix_i − g_A T_fin)/(1 − α_i),  u_i = c_i·g_rgb,
             suffix_i = Σ_{k>i} u_k w_k  (incl[K-1] − incl of a cumsum),
    and dα through α = o·e^power to the mean, conic and opacity.  dα is gated
    by live = ok & (o·e^power < 0.99): at exactly 0.99 it is 0.  Rows that
    are not valid get exactly zero; lanes 9-15 are zero.

    Given the forward's rgb output and residual S (``composite_tiles_ref(...,
    residuals=True)``), T_fin is e^S, the same bits as without them, and the
    suffix's total is g_rgb·rgb (summed r, g, b in that order) in place of
    the last inclusive sum: the same sum Σ_k u_k w_k in another order, so
    the result moves by that sum's rounding over (1 − α)."""
    T, K, _ = attrs.shape
    d_attrs = attrs.new_zeros((T, K, LANES))
    px_all, py_all = tile_pixels(T, tiles_x, tile_h, tile_w, 0.0, attrs.device, tile0)
    for s in range(0, T, chunk):
        at = attrs[s:s + chunk]                             # (C,K,16)
        dx = at[..., 0:1] - px_all[s:s + chunk, None, :]    # (C,K,P)
        dy = at[..., 1:2] - py_all[s:s + chunk, None, :]
        ca, cb, cc = at[..., 2:3], at[..., 3:4], at[..., 4:5]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        expp = torch.exp(power)
        raw = at[..., 5:6] * expp
        al = torch.clamp_max(raw, ALPHA_MAX)
        ok = (at[..., 9:10] > 0.5) & (power <= 0.0) & (al >= ALPHA_MIN)
        al = torch.where(ok, al, 0.0)
        live = ok & (raw < ALPHA_MAX)
        log1m = torch.log1p(-al)
        csum = torch.cumsum(log1m, dim=1)
        trans = torch.exp(csum - log1m)
        w = al * trans
        last = csum[:, -1:, :] if S is None else S[s:s + chunk, None, :]
        t_fin = torch.exp(last)                             # (C,1,P)
        g = g_rgb[s:s + chunk]                              # (C,P,3)
        g_a = g_alpha[s:s + chunk, None, :]                 # (C,1,P)
        d_rgb = torch.einsum("ckp,cpd->ckd", w, g)
        u = torch.einsum("ckd,cpd->ckp", at[..., 6:9], g)
        incl = torch.cumsum(u * w, dim=1)
        if rgb is None:
            total = incl[:, -1:, :]
        else:
            c = rgb[s:s + chunk]
            total = (c[..., 0] * g[..., 0] + c[..., 1] * g[..., 1]
                     + c[..., 2] * g[..., 2])[:, None, :]
        suffix = total - incl
        d_al = u * trans - (suffix - g_a * t_fin) / (1.0 - al)
        d_al = torch.where(live, d_al, 0.0)
        d_pow = d_al * al
        d = d_attrs[s:s + chunk]
        d[..., 0] = (d_pow * (-(ca * dx + cb * dy))).sum(-1)
        d[..., 1] = (d_pow * (-(cc * dy + cb * dx))).sum(-1)
        d[..., 2] = (d_pow * (-0.5 * dx * dx)).sum(-1)
        d[..., 3] = (d_pow * (-dx * dy)).sum(-1)
        d[..., 4] = (d_pow * (-0.5 * dy * dy)).sum(-1)
        d[..., 5] = (d_al * expp).sum(-1)
        d[..., 6:9] = d_rgb
    return d_attrs


def composite_bwd(attrs: torch.Tensor, g_rgb: torch.Tensor, g_alpha: torch.Tensor,
                  tiles_x: int, tile_h: int, tile_w: int, rgb=None, S=None,
                  tile0: int = 0) -> torch.Tensor:
    """attrs (T,K,16), g_rgb (T,P,3), g_alpha (T,P) f32 → d_attrs (T,K,16);
    optionally given the forward's rgb (T,P,3) and residual S (T,P) f32
    (``composite_tiles(..., residuals=True)``), so the kernel walks the rows
    once, not twice.

    A CUDA tensor goes to the kernel (``composite_bwd.launches`` counts each
    launch); a CPU tensor takes the plain twin."""
    cuda_build.check_rows(attrs, LANES, "composite_bwd")
    T, K, _ = attrs.shape
    P = tile_h * tile_w
    if tuple(g_rgb.shape) != (T, P, 3) or tuple(g_alpha.shape) != (T, P):
        raise ValueError(f"cotangents must be (T,P,3) and (T,P), got "
                         f"{tuple(g_rgb.shape)} and {tuple(g_alpha.shape)}")
    if g_rgb.dtype != torch.float32 or g_alpha.dtype != torch.float32:
        raise TypeError("cotangents must be float32")
    if (rgb is None) != (S is None):
        raise ValueError("composite_bwd takes both residuals rgb and S, or neither")
    if rgb is not None and (tuple(rgb.shape) != (T, P, 3) or tuple(S.shape) != (T, P)
                            or rgb.dtype != torch.float32 or S.dtype != torch.float32):
        raise ValueError("residuals must be rgb (T,P,3) and S (T,P) float32")
    if attrs.device.type == "cpu":
        return composite_bwd_ref(attrs, g_rgb, g_alpha, tiles_x, tile_h, tile_w,
                                 rgb=rgb, S=S, tile0=tile0)
    res = () if rgb is None else (rgb, S)
    cuda_build.check_launch(K, P, "composite_bwd", attrs, g_rgb, g_alpha, *res,
                            whole_warps=True)
    d_attrs = torch.empty((T, K, LANES), dtype=torch.float32, device=attrs.device)
    lib = cuda_build.library("composite_bwd")
    fn = lib.composite_bwd_res_launch if res else lib.composite_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * (4 + len(res)) + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    with torch.cuda.device(attrs.device):
        err = fn(attrs.data_ptr(), g_rgb.data_ptr(), g_alpha.data_ptr(),
                 *(x.data_ptr() for x in res), d_attrs.data_ptr(),
                 T, K, tiles_x, tile_h, tile_w, tile0, stream)
    cuda_build.check(err, "composite_bwd")
    composite_bwd.launches += 1
    return d_attrs


composite_bwd.launches = 0


class CompositeTiles(torch.autograd.Function):
    """Forward kernel 1, backward kernel 2, as JAX's ``make_composite_tiles``
    custom_vjp (dgmesh_tpu/ops/splat_pallas.py:264-290), which saves
    ``attrs`` and recomputes the rest in the backward.  Where attrs needs a
    gradient, the forward's rgb output and residual S (16 bytes a pixel) are
    saved too, so the backward walks the rows once; a render writes no S."""

    @staticmethod
    def forward(ctx, attrs, tiles_x: int, tile_h: int, tile_w: int, tile0: int = 0):
        ctx.geo = (tiles_x, tile_h, tile_w)
        ctx.tile0 = tile0
        rgb, alpha, *res = composite_tiles(attrs, tiles_x, tile_h, tile_w,
                                           residuals=ctx.needs_input_grad[0], tile0=tile0)
        ctx.save_for_backward(attrs, rgb, *res)
        return rgb, alpha

    @staticmethod
    def backward(ctx, g_rgb, g_alpha):
        attrs, rgb, S = ctx.saved_tensors
        with tracing.span("splat.composite_bwd"):
            d = composite_bwd(attrs, g_rgb.contiguous(), g_alpha.contiguous(), *ctx.geo, rgb,
                              S, tile0=ctx.tile0)
        return d, None, None, None, None
