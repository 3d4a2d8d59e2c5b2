"""The mesh of the Gaussians in plain PyTorch: Poisson surface reconstruction
on the FFT, then marching tetrahedra over the whole grid.

DPSR (Shape-As-Points, upstream ``nvdiffrast_utils/dpsr.py``, as the JAX
package's ``ops/dpsr.py`` computes it with ``dpsr_div_splat``): the
divergence of the oriented points, splatted with the derivative of the
periodic trilinear hat onto a res³ grid (on axes 1 and 2 the high corner
only where the point's fraction is non-zero, as the JAX splat takes it),
is solved as Δφ = ∇·N in the Fourier domain under the spectral Gaussian
exp(−½ (σ 2|k|/res)²); φ is shifted to 0 at the mean of the live points
and scaled so that the (0,0,0) corner is −0.5 (a corner of at least a
thousandth of the largest magnitude).

Marching tetrahedra (the JAX package's ``ops/marching_tets.py``): every
cube of the res³ lattice split into six tetrahedra around its main
diagonal, one vertex on each lattice edge whose ends straddle 0
(interpolated linearly, in [0,1]³ as index / (res − 1)), and per
tetrahedron one triangle (one or three corners inside) or two (two inside,
split along the diagonal from the first inside corner's edge to the first
outside corner to the second inside corner's edge to the second outside
corner), wound so that the normal points outwards.  Faces come in the
order of their cube, tetrahedron and triangle; vertices in the order of
their lattice edge.  Here every cube of the grid is looked at, a slab of
x at a time.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

# corner c of a cube sits at (c>>2 &1, c>>1 &1, c &1)
CORNERS = np.array([[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)])
TETS = np.array([[0, 4, 6, 7], [0, 6, 2, 7], [0, 2, 3, 7], [0, 3, 1, 7], [0, 1, 5, 7],
                 [0, 5, 4, 7]])
# the seven lattice edge directions from a point
DIRS = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]])
SLAB = 16


def _triangles():
    """(6 tets, 16 cases, 2, 3, 2): each triangle's corners as pairs of the
    tetrahedron's corners (inside, outside); and the triangles a case has.
    Case bit v: the tetrahedron's corner v is inside (φ ≤ 0)."""
    tris = np.zeros((6, 16, 2, 3, 2), np.int64)
    count = np.zeros((6, 16), np.int64)
    for t, case in itertools.product(range(6), range(16)):
        ins = [v for v in range(4) if case >> v & 1]
        out = [v for v in range(4) if not case >> v & 1]
        if len(ins) == 1:
            got = [[(ins[0], b) for b in out]]
        elif len(ins) == 3:
            got = [[(a, out[0]) for a in ins]]
        elif len(ins) == 2:
            (a1, a2), (b1, b2) = ins, out
            got = [[(a1, b1), (a1, b2), (a2, b2)], [(a1, b1), (a2, b2), (a2, b1)]]
        else:
            got = []
        pos = CORNERS[TETS[t]].astype(np.float64)
        for k, tri in enumerate(got):
            mids = [0.5 * (pos[a] + pos[b]) for a, b in tri]
            normal = np.cross(mids[1] - mids[0], mids[2] - mids[0])
            if np.dot(normal, pos[out].mean(0) - pos[ins].mean(0)) < 0:
                tri[1], tri[2] = tri[2], tri[1]
            tris[t, case, k] = tri
        count[t, case] = len(got)
    return tris, count


TRIS, TRI_COUNT = _triangles()


class Mesh(NamedTuple):
    verts: torch.Tensor       # (V,3) world
    faces: torch.Tensor       # (F,3) int64
    n_verts: int
    n_faces: int
    overflow: int             # active cubes, vertices and faces past the caps


def _trilinear(points, res):
    """Base corner indices (N,3) and fractions (N,3) of points in [0,1)³."""
    s = points * res
    base = torch.floor(s)
    return torch.remainder(base.long(), res), s - base


def dpsr(points: torch.Tensor, normals: torch.Tensor, alive: torch.Tensor, res: int,
         sig: float) -> torch.Tensor:
    """The indicator φ (res,res,res) of oriented points in [0,1]³."""
    dev = points.device
    normals = torch.where(alive[:, None], normals, 0.0)
    base, f = _trilinear(points, res)
    div = torch.zeros(res ** 3, dtype=points.dtype, device=dev)
    for c in range(8):
        bit = torch.as_tensor(CORNERS[c], device=dev).bool()
        hat = torch.where(bit, f, 1.0 - f)
        high = torch.where((f > 0.0) | (torch.arange(3, device=dev) == 0), float(res), 0.0)
        dhat = torch.where(bit, high, -float(res))
        val = (normals[:, 0] * dhat[:, 0] * hat[:, 1] * hat[:, 2]
               + normals[:, 1] * hat[:, 0] * dhat[:, 1] * hat[:, 2]
               + normals[:, 2] * hat[:, 0] * hat[:, 1] * dhat[:, 2])
        i = torch.remainder(base + torch.as_tensor(CORNERS[c], device=dev), res)
        div.index_add_(0, (i[:, 0] * res + i[:, 1]) * res + i[:, 2], val)
    # integer frequencies; the last axis keeps its non-negative half
    k = torch.cat([torch.arange((res + 1) // 2), torch.arange(-(res // 2), 0)]).to(
        device=dev, dtype=torch.float64)
    kz = torch.arange(res // 2 + 1, device=dev, dtype=torch.float64)
    k2 = k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz[None, None, :] ** 2
    gauss = torch.exp(-0.5 * (sig * 2.0 * torch.sqrt(k2) / res) ** 2)
    lap = -(2.0 * math.pi) ** 2 * k2
    kern = gauss / (lap + 1e-6)
    kern[0, 0, 0] = 0.0
    phi = torch.fft.irfftn(torch.fft.rfftn(div.reshape(res, res, res)) * kern.float(),
                           s=(res, res, res))
    live = torch.nonzero(alive).squeeze(1)
    b, f = _trilinear(points[live], res)
    at = 0.0
    flat = phi.reshape(-1)
    for c in range(8):
        bit = torch.as_tensor(CORNERS[c], device=dev).bool()
        w = torch.where(bit, f, 1.0 - f).prod(-1)
        i = torch.remainder(b + torch.as_tensor(CORNERS[c], device=dev), res)
        at = at + w * flat[(i[:, 0] * res + i[:, 1]) * res + i[:, 2]]
    phi = phi - at.sum() / max(live.numel(), 1)
    corner = torch.maximum(phi[0, 0, 0].abs(), 1e-3 * phi.abs().max() + 1e-20)
    return -phi / corner * 0.5


def marching_tets(phi: torch.Tensor, max_verts: int, max_faces: int):
    """The φ = 0 surface of φ (res³; inside ≤ 0): vertices (V,3) in [0,1]³,
    faces (F,3) and the count past the caps (cubes, vertices, faces)."""
    res = phi.shape[0]
    dev = phi.device
    out_ = phi > 0.0
    # vertices: every lattice edge (point, direction) whose ends differ
    gids, ends = [], []
    for k, d in enumerate(DIRS):
        a = out_[:res - d[0], :res - d[1], :res - d[2]]
        b = out_[d[0]:, d[1]:, d[2]:]
        p = torch.nonzero(a != b)
        gids.append(((p[:, 0] * res + p[:, 1]) * res + p[:, 2]) * 7 + k)
        ends.append(p)
    gid = torch.cat(gids)
    order = torch.argsort(gid)
    gid = gid[order]
    p0 = torch.cat(ends)[order]
    d = torch.as_tensor(DIRS, device=dev)[gid % 7]
    p1 = p0 + d
    f0 = phi[p0[:, 0], p0[:, 1], p0[:, 2]]
    f1 = phi[p1[:, 0], p1[:, 1], p1[:, 2]]
    den = f0 - f1
    t = f0 / torch.where(den.abs() < 1e-12, 1e-12, den)
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))
    verts = (p0.to(phi.dtype) + t[:, None] * d.to(phi.dtype)) / (res - 1)
    # faces, a slab of cubes at a time, in (cube, tet, triangle) order
    tets = torch.as_tensor(TETS, device=dev)
    tris = torch.as_tensor(TRIS, device=dev)
    tri_count = torch.as_tensor(TRI_COUNT, device=dev)
    corners = torch.as_tensor(CORNERS, device=dev)
    faces, n_active = [], 0
    n = res - 1
    for x0 in range(0, n, SLAB):
        x1 = min(x0 + SLAB, n)
        inside = ~out_[x0:x1 + 1]
        cube_in = torch.stack([inside[c[0]:c[0] + x1 - x0, c[1]:c[1] + n, c[2]:c[2] + n]
                               for c in CORNERS.tolist()], -1)           # (x, n, n, 8)
        mixed = cube_in.any(-1) & ~cube_in.all(-1)
        n_active += int(mixed.sum())
        cube = torch.nonzero(mixed)                                     # (C,3), ascending
        cin = cube_in[cube[:, 0], cube[:, 1], cube[:, 2]]              # (C,8)
        case = (cin[:, tets].long() << torch.arange(4, device=dev)).sum(-1)   # (C,6)
        has = torch.arange(2, device=dev) < tri_count[torch.arange(6, device=dev), case][..., None]
        c_i, t_i, k_i = torch.nonzero(has, as_tuple=True)
        pairs = tris[t_i, case[c_i, t_i], k_i]                          # (F,3,2) tet corners
        ca = corners[tets[t_i][:, None].expand(-1, 3, -1).gather(2, pairs[..., :1])[..., 0]]
        cb = corners[tets[t_i][:, None].expand(-1, 3, -1).gather(2, pairs[..., 1:])[..., 0]]
        lo = torch.minimum(ca, cb)
        k = ((cb - ca).abs() * torch.tensor([4, 2, 1], device=dev)).sum(-1)
        klass = torch.as_tensor(_CLASS_OF_CODE, device=dev)[k]
        pt = cube[c_i][:, None, :] + lo + torch.tensor([x0, 0, 0], device=dev)
        faces.append(((pt[..., 0] * res + pt[..., 1]) * res + pt[..., 2]) * 7 + klass)
    fg = torch.cat(faces) if faces else torch.zeros((0, 3), dtype=torch.long, device=dev)
    face_idx = torch.searchsorted(gid, fg.reshape(-1)).reshape(-1, 3)
    over = (max(n_active - max(max_verts, max_faces // 2), 0)
            + max(verts.shape[0] - max_verts, 0) + max(face_idx.shape[0] - max_faces, 0))
    return verts, face_idx, over


# lattice direction code (4 dx + 2 dy + dz) → its index in DIRS
_CLASS_OF_CODE = np.zeros(8, np.int64)
for _k, _d in enumerate(DIRS):
    _CLASS_OF_CODE[_d[0] * 4 + _d[1] * 2 + _d[2]] = _k


def mesh_of(xyz, normals, alive, density_thres, center, scale, res: int, sig: float,
            max_verts: int, max_faces: int, freeze_pos: bool = False) -> Mesh:
    """The world-space mesh of Gaussians at ``xyz`` with ``normals``: the
    points mapped into [0,1]³ by the frame (center, scale), DPSR, the field
    signed so that its (0,0,0) corner is outside and shifted by
    ``density_thres``, marching tetrahedra, and back to the world."""
    pts = xyz.detach() if freeze_pos else xyz
    p = (pts - center) / scale / 2.0 + 0.5
    p = torch.minimum(torch.maximum(p, p.new_tensor(1e-6)), p.new_tensor(1.0 - 1e-6))
    phi = dpsr(p, normals, alive, res, sig)
    s = torch.sign(phi[0, 0, 0].detach())
    phi = phi * torch.where(s == 0, 1.0, s) - density_thres
    v, f, over = marching_tets(phi, max_verts, max_faces)
    return Mesh((v * 2.0 - 1.0) * scale + center, f, v.shape[0], f.shape[0], over)
