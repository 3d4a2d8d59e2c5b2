"""Sharded DPSR: an x-slab / y-pencil decomposition of the Poisson solve.

Counterpart of dgmesh_tpu/parallel/sharded_dpsr.py (``dpsr_sharded`` :151)
for ``div_mode == "splat"``, the shipped path:

  points    one ``all_gather`` of the rank's points, normals and validity
            (N·7 numbers), so every contribution can land on its slab;
  rasterize each rank splats the divergence into its own x-slabs
            [r·R/n, (r+1)·R/n) only (ops/dpsr.py::div_rasterize's ``slabs``);
  y/z FFT   ``torch.fft.rfft2`` of the slab, local;
  x FFT     an ``all_to_all`` turns x-slabs into y-pencils (each rank then
            holds every x for R/n rows of y), ``torch.fft.fft`` along x, the
            spectral kernel G/Δ̂ on those rows, the inverse along x, and an
            ``all_to_all`` back to x-slabs;
  y/z iFFT  ``torch.fft.irfft2`` of the slab;
  shift     the slabs gathered on every rank, then the point-mean shift and
            the corner scale on the whole grid, as DPSR.__call__ does.

JAX does the transforms as matmul DFTs because ``jnp.fft`` fails to
differentiate inside ``shard_map``; torch's FFTs differentiate, so here they
are FFTs.  The gradients are autograd's, with the collectives' transposes of
parallel/sharding.py.
"""

from __future__ import annotations

import torch

from ..ops.dpsr import DPSR, div_rasterize, grid_interp
from .sharding import DeviceMesh, all_gather, all_to_all


def dpsr_sharded(mesh: DeviceMesh, op: DPSR, points, normals, valid) -> torch.Tensor:
    """points, normals (N_l,3) and valid (N_l,) the rank's rows; returns the
    whole indicator grid (R,R,R) on every rank, as ``op(points, normals,
    valid)`` of the gathered rows.  Needs ``op.div_mode == "splat"`` and a
    grid divisible by the number of ranks."""
    if op.div_mode != "splat":
        raise NotImplementedError("sharded DPSR implements the splat (divergence-rasterize) "
                                  "path only")
    n, r = mesh.world, mesh.rank
    r0, r1, r2 = op.res
    if r0 % n or r1 % n:
        raise ValueError(f"grid_res={op.res} not divisible by the {n}-rank mesh")
    nx, ny = r0 // n, r1 // n
    rh = r2 // 2 + 1
    points = all_gather(points, mesh)
    normals = all_gather(normals, mesh)
    valid = all_gather(valid, mesh)
    normals = torch.where(valid[:, None], normals, 0.0)

    div = div_rasterize(points, normals, op.res, slabs=(r * nx, (r + 1) * nx))
    spec = torch.fft.rfft2(div, dim=(1, 2))                      # (nx, R1, rh)
    # x-slabs → y-pencils: y-block j goes to rank j
    spec = spec.reshape(nx, n, ny, rh).transpose(0, 1).reshape(n * nx, ny, rh)
    pencil = all_to_all(spec, mesh)                              # (R0, ny, rh), x in rank order
    pencil = torch.fft.fft(pencil, dim=0) * op.kern[:, r * ny:(r + 1) * ny]
    pencil = torch.fft.ifft(pencil, dim=0)
    # y-pencils → x-slabs: x-block j goes to rank j
    slab = all_to_all(pencil.contiguous(), mesh)                 # (n·nx, ny, rh), y-block i
    slab = slab.reshape(n, nx, ny, rh).transpose(0, 1).reshape(nx, r1, rh)
    phi = torch.fft.irfft2(slab, s=(r1, r2), dim=(1, 2))
    phi = all_gather(phi.contiguous(), mesh)                     # (R0, R1, R2)

    if op.shift:
        live = torch.nonzero(valid).squeeze(1)
        fv = grid_interp(phi, points[live], op.res)
        phi = phi - fv.sum() / max(live.numel(), 1)
    if op.scale:
        fv0 = phi[0, 0, 0]
        denom = torch.maximum(fv0.abs(), 1e-3 * phi.abs().max() + 1e-20)
        phi = -phi / denom * 0.5
    return phi
