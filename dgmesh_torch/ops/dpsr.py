"""Differentiable Poisson Surface Reconstruction (DPSR) on the 3D FFT.

Counterpart of dgmesh_tpu/ops/dpsr.py (reference nvdiffrast_utils/dpsr.py:9-70
and dpsr_utils.py).  Splat oriented point normals (or their divergence) onto
a periodic res³ grid, solve the screened Poisson equation in the Fourier
domain with a spectral Gaussian low-pass, invert, then shift so the indicator
is 0 at the input points and scale so the (0,0,0) corner is ±0.5.

The JAX version splats through slab matmuls and can solve with a matmul DFT
(both for the TPU); here the splat is ``index_add_`` over the 8 periodic
trilinear corners and the solve is ``torch.fft.rfftn``/``irfftn``.  The
gradients for points and normals are autograd's of ``index_add_``, the FFTs
and the trilinear gather; JAX's custom VJPs there (slab splats, a
gather-only permutation) are TPU workarounds and have no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def fftfreqs3(res: Tuple[int, int, int]) -> np.ndarray:
    """Integer frequency grids in rfftn layout (r0, r1, r2//2+1, 3) float32:
    full for axes 0, 1; non-negative half for axis 2."""
    freqs = [np.fft.fftfreq(r) * r if i < 2 else np.arange(r // 2 + 1, dtype=np.float64)
             for i, r in enumerate(res)]
    return np.stack(np.meshgrid(*freqs, indexing="ij"), axis=-1).astype(np.float32)


def spec_gaussian_filter(res, sig: float) -> np.ndarray:
    """exp(-2 (σ π |ω|/res)²) spectral low-pass (dpsr_utils :66-72)."""
    omega = fftfreqs3(res)
    dis = np.sqrt((omega ** 2).sum(-1))
    return np.exp(-0.5 * ((sig * 2 * dis / res[0]) ** 2)).astype(np.float32)


def _base_and_frac(points: torch.Tensor, res):
    """Wrapped base cell (N,3) in [0,res) and the fractional offset (N,3)."""
    r = torch.as_tensor(res, dtype=points.dtype, device=points.device)
    scaled = points * r
    i0f = torch.floor(scaled)
    frac = scaled - i0f
    i0 = torch.remainder(i0f.long(), r.long())
    return i0, frac


def _corners(i0: torch.Tensor, res):
    """Flat indices (N,8) of the 8 periodic corners; corner c has bits
    (c>>2 &1, c>>1 &1, c &1) on axes (0,1,2)."""
    r0, r1, r2 = res
    bits = torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)],
                        device=i0.device)
    idx = i0[:, None, :] + bits[None]                          # (N,8,3)
    idx = torch.remainder(idx, torch.tensor(res, device=i0.device))
    return (idx[..., 0] * r1 + idx[..., 1]) * r2 + idx[..., 2], bits


def point_rasterize(points: torch.Tensor, values: torch.Tensor, res) -> torch.Tensor:
    """Trilinear splat of per-point vectors into a periodic grid (r0,r1,r2,C)
    (reference dpsr_utils.point_rasterize :140-197)."""
    i0, frac = _base_and_frac(points, res)
    flat, bits = _corners(i0, res)
    hat = torch.where(bits[None].bool(), frac[:, None, :], 1.0 - frac[:, None, :])  # (N,8,3)
    w = hat[..., 0] * hat[..., 1] * hat[..., 2]                # (N,8)
    C = values.shape[-1]
    grid = torch.zeros((res[0] * res[1] * res[2], C), dtype=values.dtype, device=values.device)
    grid.index_add_(0, flat.reshape(-1), (w[..., None] * values[:, None, :]).reshape(-1, C))
    return grid.reshape(*res, C)


def div_rasterize(points: torch.Tensor, normals: torch.Tensor, res,
                  slabs: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Splat the (negated) divergence of the oriented point set (r0,r1,r2):
    per corner, Σ_d n_d · res_d · ∂_d of the trilinear hat.  With ``slabs``
    = (x0, x1), only the x-slabs x0 … x1 − 1 of the grid, (x1 − x0, r1, r2):
    the contributions that land there, summed in the same order (a rank of
    the multi-device DPSR, parallel/sharded_dpsr.py; JAX's ``slab_ids``).

    The derivative hat is −res on the low corner and +res on the high one.
    On axes 1 and 2 the high corner's +res is taken only where the fraction
    is non-zero, as the JAX slab form's ``_axis_dhat`` does (at a zero
    fraction that corner lies a full cell away)."""
    r0, r1, r2 = res
    i0, frac = _base_and_frac(points, res)
    flat, bits = _corners(i0, res)
    b = bits[None].bool()                                      # (1,8,3)
    f = frac[:, None, :]                                       # (N,1,3)
    hat = torch.where(b, f, 1.0 - f)                           # (N,8,3)
    rs = torch.tensor([float(r0), float(r1), float(r2)], device=points.device)
    high = torch.where((f > 0.0) | (torch.arange(3, device=points.device) == 0), rs, 0.0)
    dhat = torch.where(b, high, -rs)                           # (N,8,3)
    val = (normals[:, None, 0] * dhat[..., 0] * hat[..., 1] * hat[..., 2]
           + normals[:, None, 1] * hat[..., 0] * dhat[..., 1] * hat[..., 2]
           + normals[:, None, 2] * hat[..., 0] * hat[..., 1] * dhat[..., 2])
    flat, val = flat.reshape(-1), val.reshape(-1)
    x0, x1 = (0, r0) if slabs is None else slabs
    if slabs is not None:
        keep = torch.nonzero((flat >= x0 * r1 * r2) & (flat < x1 * r1 * r2)).squeeze(1)
        flat, val = flat[keep] - x0 * r1 * r2, val[keep]
    grid = torch.zeros((x1 - x0) * r1 * r2, dtype=normals.dtype, device=normals.device)
    grid.index_add_(0, flat, val)
    return grid.reshape(x1 - x0, r1, r2)


def grid_interp(grid: torch.Tensor, points: torch.Tensor, res) -> torch.Tensor:
    """Trilinear gather from a periodic grid (forward of the JAX op).

    grid (r0,r1,r2) or (r0,r1,r2,C); points (N,3) in [0,1)."""
    squeeze = grid.dim() == 3
    g = grid.reshape(res[0] * res[1] * res[2], -1)
    i0, frac = _base_and_frac(points, res)
    flat, bits = _corners(i0, res)
    hat = torch.where(bits[None].bool(), frac[:, None, :], 1.0 - frac[:, None, :])
    w = hat[..., 0] * hat[..., 1] * hat[..., 2]                # (N,8)
    out = (w[..., None] * g[flat]).sum(1)                      # (N,C)
    return out[:, 0] if squeeze else out


class DPSR:
    """Stateless DPSR operator; precomputes the spectral constants once
    (reference nvdiffrast_utils/dpsr.py DPSR :9-70)."""

    def __init__(self, res: Tuple[int, int, int], sig: float = 10.0,
                 scale: bool = True, shift: bool = True,
                 div_mode: str = "spectral", device=None):
        assert div_mode in ("spectral", "splat")
        self.res = tuple(res)
        self.sig = sig
        self.scale = scale
        self.shift = shift
        self.div_mode = div_mode
        G = spec_gaussian_filter(self.res, sig)                    # (r0,r1,rh)
        omega = fftfreqs3(self.res) * np.float32(2 * np.pi)        # (r0,r1,rh,3)
        lap = -(omega ** 2).sum(-1)
        kern = G / (lap + np.float32(1e-6))                        # G/Δ̂, DC zeroed
        kern.flat[0] = 0.0
        f32 = dict(dtype=torch.float32, device=device)
        self.G = torch.as_tensor(G, **f32)
        self.omega = torch.as_tensor(omega, **f32)
        self.lap = torch.as_tensor(lap, **f32)
        self.kern = torch.as_tensor(kern, **f32)

    def __call__(self, points: torch.Tensor, normals: torch.Tensor,
                 point_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """points (N,3) in [0,1], normals (N,3) → indicator grid (r0,r1,r2)."""
        dims = (0, 1, 2)
        if point_valid is not None:
            normals = torch.where(point_valid[:, None], normals, 0.0)
        if self.div_mode == "splat":
            div_g = div_rasterize(points, normals, self.res)
            phi = torch.fft.irfftn(torch.fft.rfftn(div_g, dim=dims) * self.kern,
                                   s=self.res, dim=dims)
        else:
            ras = point_rasterize(points, normals, self.res)       # (r0,r1,r2,3)
            spec = torch.fft.rfftn(ras, dim=dims) * self.G[..., None]
            div = (-1j * spec * self.omega).sum(-1)                # Σ_d -i ω_d N̂_d
            phi_hat = div / (self.lap + 1e-6)
            phi_hat[0, 0, 0] = 0.0
            phi = torch.fft.irfftn(phi_hat, s=self.res, dim=dims)

        if self.shift or self.scale:
            if self.shift:
                if point_valid is not None:
                    # only the valid points: the gather's backward then does
                    # not pile every padded point on one cell
                    live = torch.nonzero(point_valid).squeeze(1)
                    fv = grid_interp(phi, points[live], self.res)
                    offset = fv.sum() / max(live.numel(), 1)
                else:
                    offset = grid_interp(phi, points, self.res).mean()
                phi = phi - offset
            if self.scale:
                fv0 = phi[0, 0, 0]
                # guarded division, as in the JAX version (dpsr.py:477-489):
                # a degenerate, flat field must not divide by ~0
                denom = torch.maximum(fv0.abs(), 1e-3 * phi.abs().max() + 1e-20)
                phi = -phi / denom * 0.5
        return phi
