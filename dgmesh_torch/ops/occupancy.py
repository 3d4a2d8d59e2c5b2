"""Gaussian-mixture occupancy field on a regular grid, and surface sampling.

Counterpart of dgmesh_tpu/ops/occupancy.py (reference utils/mesh_utils.py
get_opacity_field_from_gaussians :7-77), used once at dpsr_iter to
initialise normals (occupancy grid → marching tets → surface samples → kNN
normal transfer, dgmesh_tpu/train/densify.py::normal_initialization).

The field is Σᵢ opacityᵢ·exp(−½ qᵢ) over the live Gaussians, each term kept
only where its quadratic form qᵢ = ‖Rᵢᵀ d / sᵢ‖² is below CUTOFF²·3, as in
JAX.  JAX evaluates every (grid point, Gaussian) pair; here the grid is cut
into bricks of BRICK³ points and each brick meets only the Gaussians whose
cutoff box (the ellipsoid qᵢ < CUTOFF²·3 has half-widths
CUTOFF·√3·‖(R diag s)[a]‖ along world axis a) overlaps it, the reference's
own per-block culling (mesh_utils.py:48-54).  The same terms are summed, in
Gaussian order per point, in another association than JAX's: values agree
to float32 rounding.  Each brick's sum runs over a padded (brick, Gaussian,
point) block, so the result is deterministic.
"""

from __future__ import annotations

from typing import Optional

import torch

from .laplacian import face_areas, face_normals
from .quaternion import quat_to_rotmat

CUTOFF = 3.0              # σ: a term counts where q < CUTOFF² · 3 (JAX's cutoff)
BRICK = 8                 # grid points per brick edge
BLOCK_ELEMS = 1 << 24     # (brick, Gaussian, point) triples evaluated at once


def _grid_points(idx: torch.Tensor, res: int, center, half_extent: float) -> torch.Tensor:
    """World positions of flat grid indices, with the JAX version's float32
    operations: ((i + 0.5) / res · 2 − 1) · half_extent + center."""
    ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res], -1)
    cell = (ijk.to(torch.float32) + 0.5) / res * 2.0 - 1.0
    return cell * half_extent + center


def gaussian_occupancy_grid(xyz, scaling, rotation, opacity, alive, center,
                            half_extent: float, res: int) -> torch.Tensor:
    """The opacity field on a res³ grid spanning center ± half_extent,
    (res,res,res) float32.  xyz, scaling (activated) (N,3), rotation (N,4),
    opacity (N,1) or (N,), alive (N,) bool."""
    dev = xyz.device
    center = torch.as_tensor(center, dtype=torch.float32, device=dev)
    brick = BRICK
    q_max = CUTOFF * CUTOFF * 3.0
    live = torch.nonzero(alive).reshape(-1)
    x = xyz[live]
    R = quat_to_rotmat(rotation[live])                       # (G,3,3)
    s = torch.clamp_min(scaling[live], 1e-8)
    inv_s = 1.0 / s
    op = opacity.reshape(-1)[live]
    nb = -(-res // brick)
    grid = torch.zeros(res ** 3, dtype=torch.float32, device=dev)
    if live.numel() == 0:
        return grid.reshape(res, res, res)

    # each Gaussian's cutoff box in grid index space, one voxel wider than
    # its float32 rounding could need, then in bricks
    half = (q_max ** 0.5) * torch.linalg.norm(R * s[:, None, :], dim=-1)   # (G,3)
    half = half * 1.001 + 1e-6
    to_idx = lambda w: ((w - center) / half_extent + 1.0) * (res / 2.0) - 0.5  # noqa: E731
    lo = torch.floor(to_idx(x - half)).long() - 1
    hi = torch.ceil(to_idx(x + half)).long() + 1
    blo = torch.clamp(lo, 0, res - 1) // brick
    bhi = torch.clamp(hi, 0, res - 1) // brick
    inside = ((hi >= 0) & (lo <= res - 1)).all(-1)
    ext = torch.where(inside[:, None], bhi - blo + 1, 0)               # bricks per axis
    counts = ext.prod(-1)
    gid = torch.repeat_interleave(torch.arange(x.shape[0], device=dev), counts)
    j = torch.arange(gid.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[gid]
    e = ext[gid]
    bx = blo[gid, 0] + j // (e[:, 1] * e[:, 2])
    by = blo[gid, 1] + (j // e[:, 2]) % e[:, 1]
    bz = blo[gid, 2] + j % e[:, 2]
    bid = (bx * nb + by) * nb + bz
    # pairs by brick, each brick's Gaussians in ascending order
    bid, order = torch.sort(bid, stable=True)
    gid = gid[order]
    bricks, per = torch.unique_consecutive(bid, return_counts=True)
    start = torch.cumsum(per, 0) - per
    # the fullest bricks first, so that a block's bricks pad to similar counts
    by_count = torch.sort(per, descending=True, stable=True).indices
    bricks, per, start = bricks[by_count], per[by_count], start[by_count]

    off = torch.arange(brick ** 3, device=dev)
    off = torch.stack([off // (brick * brick), (off // brick) % brick, off % brick], -1)
    Rt = R.transpose(1, 2)
    per_h = per.tolist()
    b0 = 0
    while b0 < len(per_h):
        # bricks b0..b1-1, padded to their largest Gaussian count L
        b1, L = b0, 0
        while b1 < len(per_h) and max(L, per_h[b1]) * (b1 - b0 + 1) * brick ** 3 <= BLOCK_ELEMS:
            L = max(L, per_h[b1])
            b1 += 1
        if b1 == b0:                      # one brick alone over the budget
            L, b1 = per_h[b0], b0 + 1
        br = bricks[b0:b1]
        rank = torch.arange(L, device=dev)
        valid = rank[None, :] < per[b0:b1, None]                            # (nb_c, L)
        g = gid[torch.where(valid, start[b0:b1, None] + rank[None, :], 0)]  # (nb_c, L)
        bxyz = torch.stack([br // (nb * nb), (br // nb) % nb, br % nb], -1) * brick
        pijk = bxyz[:, None, :] + off[None]                                 # (nb_c, B³, 3)
        in_grid = (pijk < res).all(-1)
        pidx = (pijk[..., 0] * res + pijk[..., 1]) * res + pijk[..., 2]
        p = _grid_points(torch.where(in_grid, pidx, 0), res, center, half_extent)
        d = p[:, None, :, :] - x[g][:, :, None, :]                          # (nb_c, L, B³, 3)
        local = torch.einsum("blij,blpj->blpi", Rt[g], d)
        q = ((local * inv_s[g][:, :, None, :]) ** 2).sum(-1)
        val = op[g][:, :, None] * torch.exp(-0.5 * q)
        val = torch.where((q < q_max) & valid[:, :, None], val, 0.0)
        acc = val.sum(1)                                                    # (nb_c, B³)
        grid[pidx[in_grid]] = acc[in_grid]
        b0 = b1
    return grid.reshape(res, res, res)


def sample_mesh_surface(verts, faces, face_valid, n_samples: int,
                        gen: Optional[torch.Generator] = None, u=None, uv=None):
    """Uniform area-weighted surface samples (reference: trimesh.sample in
    normal_initialization :712-717).  Returns (points (S,3), face normals
    (S,3)).

    An inverse-CDF draw: a cumulative sum of the face areas and
    ``torch.searchsorted``, never an (S, F) tensor.  The draws, ``u`` (S,)
    uniform on [0, 1) (scaled by the total area here, as the JAX version's
    maxval does) and ``uv`` (S,2) uniform, come from ``gen`` on the
    device's generator unless given."""
    dev = verts.device
    areas = face_areas(verts, faces, face_valid)
    p = areas / torch.clamp_min(areas.sum(), 1e-12)
    cdf = torch.cumsum(p, 0)
    if u is None:
        u = torch.rand((n_samples,), generator=gen, device=dev)
    if uv is None:
        uv = torch.rand((n_samples, 2), generator=gen, device=dev)
    u = u.to(dev) * cdf[-1]
    fidx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, p.shape[0] - 1)
    tri = verts[faces[fidx]]                                   # (S,3,3)
    uv = uv.to(dev)
    su = torch.sqrt(uv[:, :1])
    b0 = 1.0 - su
    b1 = su * (1.0 - uv[:, 1:])
    b2 = su * uv[:, 1:]
    pts = b0 * tri[:, 0] + b1 * tri[:, 1] + b2 * tri[:, 2]
    return pts, face_normals(verts, faces, face_valid)[fidx]
