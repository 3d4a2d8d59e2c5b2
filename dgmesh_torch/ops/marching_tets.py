"""Iso-surface extraction by marching tetrahedra (6-tet cube split).

Counterpart of dgmesh_tpu/ops/marching_tets.py (replacing the reference's
diso.DiffMC).  The tables are the JAX version's, derived the same way at
import time.  Active cubes are compacted with ``torch.nonzero`` (ascending,
as the JAX compaction); vertices are the crossing lattice edges of the
active cubes, with ids ``cube_gid·7 + class`` in ascending order; each face
corner finds its vertex with ``torch.searchsorted``.  Capacities truncate
exactly as the JAX version does and report the dropped count in ``overflow``.
The topology carries no gradient; the vertex positions are differentiable
in the field through the edge interpolation ``t = φ0 / (φ0 − φ1)``.

Field convention: outside > 0 > inside; triangles wind right-handed around
the outward normal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Cube corners, x-major bit layout: corner i = (i>>2 & 1, i>>1 & 1, i & 1).
_CORNERS = np.array([[(i >> 2) & 1, (i >> 1) & 1, i & 1] for i in range(8)],
                    np.int32)
# 6-tet decomposition around the main diagonal corner 0 – corner 7.
_TETS = np.array([
    [0, 4, 6, 7],
    [0, 6, 2, 7],
    [0, 2, 3, 7],
    [0, 3, 1, 7],
    [0, 1, 5, 7],
    [0, 5, 4, 7],
], np.int32)

_TET_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], np.int32)

# 7 lattice edge classes (direction from the anchor point).
_EDGE_DIRS = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1],
    [1, 1, 0], [1, 0, 1], [0, 1, 1],
    [1, 1, 1],
], np.int32)
_DIR_TO_CLASS = {tuple(d): i for i, d in enumerate(_EDGE_DIRS)}


def _build_tables():
    """Per-tet 16-case triangle table with verified orientation, and the
    (tet, tet_edge) → (anchor offset, edge class) map."""
    edge_anchor = np.zeros((6, 6, 3), np.int32)
    edge_class = np.zeros((6, 6), np.int32)
    for t in range(6):
        for e in range(6):
            a, b = _TET_EDGES[e]
            ca, cb = _CORNERS[_TETS[t, a]], _CORNERS[_TETS[t, b]]
            edge_anchor[t, e] = np.minimum(ca, cb)
            edge_class[t, e] = _DIR_TO_CLASS[tuple(np.abs(cb - ca))]

    tri_table = np.full((6, 16, 2, 3), -1, np.int32)
    tri_count = np.zeros((6, 16), np.int32)

    def edge_of(a, b):
        for e in range(6):
            if set(_TET_EDGES[e]) == {a, b}:
                return e
        raise KeyError((a, b))

    for t in range(6):
        pos = _CORNERS[_TETS[t]].astype(np.float64)       # (4,3) corner coords
        emid = {e: 0.5 * (pos[_TET_EDGES[e, 0]] + pos[_TET_EDGES[e, 1]])
                for e in range(6)}
        for case in range(16):
            inside = [v for v in range(4) if (case >> v) & 1]
            outside = [v for v in range(4) if not ((case >> v) & 1)]
            tris = []
            if len(inside) == 1:
                tris.append([edge_of(inside[0], b) for b in outside])
            elif len(inside) == 3:
                tris.append([edge_of(a, outside[0]) for a in inside])
            elif len(inside) == 2:
                a1, a2 = inside
                b1, b2 = outside
                e11, e12 = edge_of(a1, b1), edge_of(a1, b2)
                e22, e21 = edge_of(a2, b2), edge_of(a2, b1)
                tris.append([e11, e12, e22])
                tris.append([e11, e22, e21])
            # orient: the right-hand normal points inside → outside
            for k, tri in enumerate(tris):
                v0, v1, v2 = (emid[e] for e in tri)
                n = np.cross(v1 - v0, v2 - v0)
                want = np.mean(pos[outside], axis=0) - np.mean(pos[inside], axis=0)
                if np.dot(n, want) < 0:
                    tri[1], tri[2] = tri[2], tri[1]
                tri_table[t, case, k] = tri
            tri_count[t, case] = len(tris)
    return edge_anchor, edge_class, tri_table, tri_count


_EDGE_ANCHOR_NP, _EDGE_CLASS_NP, _TRI_TABLE_NP, _TRI_COUNT_NP = _build_tables()
# corner-bit index of each _EDGE_DIRS offset ((dx,dy,dz) → dx*4+dy*2+dz)
_CLASS_CORNER_BIT = np.array([d[0] * 4 + d[1] * 2 + d[2] for d in _EDGE_DIRS], np.int64)


class MTConfig(NamedTuple):
    res: int
    max_verts: int
    max_faces: int
    max_cubes: int


class MeshResult(NamedTuple):
    verts: torch.Tensor        # (max_verts, 3) in [0,1]³, zero padded
    faces: torch.Tensor        # (max_faces, 3) int64 vertex indices, zero padded
    n_verts: torch.Tensor      # () int64
    n_faces: torch.Tensor      # () int64
    vert_valid: torch.Tensor   # (max_verts,) bool
    face_valid: torch.Tensor   # (max_faces,) bool
    overflow: torch.Tensor     # () int64: dropped cubes + verts + faces


def marching_tets(phi: torch.Tensor, cfg: MTConfig) -> MeshResult:
    """Extract the φ=0 iso-surface of a res³ field (outside > 0).

    The cube lattice is res³ with edge-replicated sign padding: anchors
    ≤ res-2 are real cubes and emit faces; the boundary pseudo-cubes only own
    their anchored lattice edges, as in the JAX version."""
    res = cfg.res
    dev = phi.device
    lt = dict(dtype=torch.long, device=dev)
    phi = phi.reshape(res, res, res)
    S = (phi > 0.0).to(torch.int32)                      # 1 = outside
    S = torch.cat([S, S[-1:]], 0)
    S = torch.cat([S, S[:, -1:]], 1)
    S = torch.cat([S, S[:, :, -1:]], 2)
    packed = torch.zeros((res, res, res), dtype=torch.int32, device=dev)
    for i in range(8):
        dx, dy, dz = (i >> 2) & 1, (i >> 1) & 1, i & 1
        packed |= S[dx:dx + res, dy:dy + res, dz:dz + res] << i
    packed = packed.reshape(-1)

    active = torch.nonzero((packed != 0) & (packed != 255)).reshape(-1)
    n_cubes = torch.tensor(active.numel(), **lt)
    cube_ids = active[:cfg.max_cubes]
    case8 = packed[cube_ids].long()
    cpos = torch.stack([cube_ids // (res * res), (cube_ids // res) % res,
                        cube_ids % res], dim=-1)        # (C,3)

    # ---- vertices: the crossing edges among each cube's 7 anchored classes
    dirs = torch.as_tensor(_EDGE_DIRS, **lt)
    s_nb = (case8[:, None] >> torch.as_tensor(_CLASS_CORNER_BIT, device=dev)) & 1
    in_grid = ((cpos[:, None, :] + dirs[None]) <= res - 1).all(-1)
    edge_cross = (s_nb != (case8 & 1)[:, None]) & in_grid          # (C,7)
    slots = torch.nonzero(edge_cross.reshape(-1)).reshape(-1)
    n_verts = torch.tensor(slots.numel(), **lt)
    slots = slots[:cfg.max_verts]
    nv = slots.numel()
    vcube = slots // 7
    klass = slots % 7
    edge_gids = cube_ids[vcube] * 7 + klass                          # ascending

    p0 = cpos[vcube]
    d = dirs[klass]
    p1 = (p0 + d).clamp(0, res - 1)
    phi_flat = phi.reshape(-1)
    f0 = phi_flat[(p0[:, 0] * res + p0[:, 1]) * res + p0[:, 2]]
    f1 = phi_flat[(p1[:, 0] * res + p1[:, 1]) * res + p1[:, 2]]
    denom = f0 - f1
    t = f0 / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    # jnp.clip's gradient at a bound: half, as minimum/maximum split ties
    # (torch.clamp would pass all of it)
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))
    verts = torch.zeros((cfg.max_verts, 3), dtype=phi.dtype, device=dev)
    verts[:nv] = (p0.to(phi.dtype) + t[:, None] * d.to(phi.dtype)) / (res - 1)

    # ---- faces: real cubes (anchor ≤ res-2 on every axis) × 6 tets × ≤2 tris
    face_src_ok = (cpos <= res - 2).all(-1)
    tets = torch.as_tensor(_TETS, **lt)                              # (6,4)
    corner_in = ((case8[:, None, None] >> tets[None]) & 1) == 0      # (C,6,4)
    tet_case = sum(corner_in[..., v].long() << v for v in range(4))  # (C,6)
    counts = torch.as_tensor(_TRI_COUNT_NP, **lt)[torch.arange(6, device=dev)[None, :], tet_case]
    tri_valid = (torch.arange(2, device=dev)[None, None, :] < counts[:, :, None]) \
        & face_src_ok[:, None, None]                                 # (C,6,2)
    face_slots = torch.nonzero(tri_valid.reshape(-1)).reshape(-1)
    n_faces = torch.tensor(face_slots.numel(), **lt)
    face_slots = face_slots[:cfg.max_faces]
    nf = face_slots.numel()
    fcube = face_slots // 12
    frem = face_slots % 12
    ftet = frem // 2
    fk = frem % 2
    fcase = tet_case[fcube, ftet]
    ftris = torch.as_tensor(_TRI_TABLE_NP, **lt)[ftet, fcase, fk].clamp_min(0)  # (F,3)
    a = _EDGE_ANCHOR_NP
    geid_delta = torch.as_tensor(
        ((a[..., 0] * res + a[..., 1]) * res + a[..., 2]) * 7 + _EDGE_CLASS_NP, **lt)
    face_geid = cube_ids[fcube][:, None] * 7 + geid_delta[ftet[:, None], ftris]
    vidx = torch.searchsorted(edge_gids, face_geid.reshape(-1), side="left")
    faces = torch.zeros((cfg.max_faces, 3), **lt)
    faces[:nf] = vidx.clamp_max(cfg.max_verts - 1).reshape(-1, 3)

    vert_valid = torch.arange(cfg.max_verts, device=dev) < nv
    face_valid = torch.arange(cfg.max_faces, device=dev) < nf
    overflow = ((n_cubes - cfg.max_cubes).clamp_min(0)
                + (n_verts - cfg.max_verts).clamp_min(0)
                + (n_faces - cfg.max_faces).clamp_min(0))
    return MeshResult(verts=verts, faces=faces,
                      n_verts=torch.tensor(nv, **lt), n_faces=torch.tensor(nf, **lt),
                      vert_valid=vert_valid, face_valid=face_valid, overflow=overflow)
