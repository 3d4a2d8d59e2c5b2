"""Sharded marching tetrahedra: an x-slab decomposition.

Counterpart of dgmesh_tpu/parallel/sharded_mt.py (``marching_tets_sharded``
:204, ``_percap`` :59), with ops/marching_tets.py's ``torch.nonzero`` /
``torch.searchsorted`` in place of JAX's compaction and scans:

  cubes  a cube belongs to the rank whose x-slab [r·R/n, (r+1)·R/n) holds
         its anchor; the corner signs of the slab's last plane need the
         next rank's first φ-plane, one (1,R,R) ``ppermute`` halo (the last
         rank repeats its own last plane, as the edge padding does);
  verts  each cube owns its 7 anchored lattice edges, so a rank finds its
         vertices alone; they fill slot block [r·Vc, (r+1)·Vc) of the
         stitched array in ascending edge id, so the concatenated blocks'
         valid vertices are the single-device vertices in their order;
  faces  a face corner on an edge anchored in the next rank's first plane
         is found in that rank's first-plane vertex table, (halo_cap, 2)
         pairs (edge id, stitched slot) sent back by one more ``ppermute``;
         faces index the stitched vertex array.

Valid vertices and faces are a prefix of each rank's block (block-prefix
layout, not a global prefix); the counts and the overflow are global.  The
per-rank capacities are the global ones over n with 2x headroom (at least
256, at most the global cap); ``halo_cap`` is min(max_verts, 8·R²).
"""

from __future__ import annotations

import torch

from ..ops.marching_tets import (MTConfig, MeshResult, _CLASS_CORNER_BIT, _EDGE_ANCHOR_NP,
                                 _EDGE_CLASS_NP, _EDGE_DIRS, _TETS, _TRI_COUNT_NP,
                                 _TRI_TABLE_NP)
from .sharding import DeviceMesh, all_gather, ppermute, psum


def percap(total: int, n: int, floor: int = 256) -> int:
    """A rank's capacity: 2·⌈total/n⌉, at least ``floor``, at most ``total``."""
    return int(min(total, max(2 * (-(-total // n)), floor)))


def marching_tets_sharded(mesh: DeviceMesh, phi: torch.Tensor, cfg: MTConfig,
                          halo_cap: int = 0) -> MeshResult:
    """phi: the whole (R,R,R) field, the same on every rank.  Returns the
    rank's block: verts (Vc,3), faces (Fc,3) indexing the stitched vertex
    array (n·Vc rows, ``stitch``), their validity, and the global counts and
    overflow."""
    n, r = mesh.world, mesh.rank
    res = cfg.res
    if res % n:
        raise ValueError(f"grid res={res} not divisible by the {n}-rank mesh")
    halo_cap = halo_cap or int(min(cfg.max_verts, 8 * res * res))
    nloc = res // n
    x0 = r * nloc
    c_cap, v_cap, f_cap = (percap(c, n) for c in (cfg.max_cubes, cfg.max_verts, cfg.max_faces))
    dev = phi.device
    lt = dict(dtype=torch.long, device=dev)
    phi = phi.reshape(res, res, res)
    phi_l = phi[x0:x0 + nloc]

    # the φ halo: the next rank's first plane; the last rank repeats its own
    # (torch.where, not a branch: the ppermute stays in every rank's graph,
    # so every rank runs its transpose in the backward)
    nxt = ppermute(phi_l[:1].contiguous(), mesh, -1)
    nxt = torch.where(torch.tensor(r == n - 1, device=dev), phi_l[-1:], nxt)
    phi_h = torch.cat([phi_l, nxt], 0)                       # (nloc+1, R, R)

    S = (phi_h > 0.0).to(torch.int32)
    S = torch.cat([S, S[:, -1:]], 1)
    S = torch.cat([S, S[:, :, -1:]], 2)
    packed = torch.zeros((nloc, res, res), dtype=torch.int32, device=dev)
    for i in range(8):
        dx, dy, dz = (i >> 2) & 1, (i >> 1) & 1, i & 1
        packed |= S[dx:dx + nloc, dy:dy + res, dz:dz + res] << i
    packed = packed.reshape(-1)

    active = torch.nonzero((packed != 0) & (packed != 255)).reshape(-1)
    n_cubes = torch.tensor(active.numel(), **lt)
    loc_ids = active[:c_cap]
    case8 = packed[loc_ids].long()
    cube_gids = loc_ids + x0 * res * res                     # x-major global ids
    cpos = torch.stack([loc_ids // (res * res) + x0, (loc_ids // res) % res, loc_ids % res],
                       dim=-1)

    # ---- vertices
    dirs = torch.as_tensor(_EDGE_DIRS, **lt)
    s_nb = (case8[:, None] >> torch.as_tensor(_CLASS_CORNER_BIT, device=dev)) & 1
    in_grid = ((cpos[:, None, :] + dirs[None]) <= res - 1).all(-1)
    edge_cross = (s_nb != (case8 & 1)[:, None]) & in_grid
    slots = torch.nonzero(edge_cross.reshape(-1)).reshape(-1)
    n_verts = torch.tensor(slots.numel(), **lt)
    slots = slots[:v_cap]
    nv = slots.numel()
    vcube, klass = slots // 7, slots % 7
    edge_gids = cube_gids[vcube] * 7 + klass                 # ascending
    p0 = cpos[vcube]
    d = dirs[klass]
    p1 = (p0 + d).clamp(0, res - 1)
    ph = phi_h.reshape(-1)

    def fetch(p):
        return ph[((p[:, 0] - x0) * res + p[:, 1]) * res + p[:, 2]]

    f0, f1 = fetch(p0), fetch(p1)
    denom = f0 - f1
    t = f0 / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    t = torch.minimum(torch.maximum(t, t.new_zeros(())), t.new_ones(()))
    verts = phi.new_zeros((v_cap, 3))
    verts[:nv] = (p0.to(phi.dtype) + t[:, None] * d.to(phi.dtype)) / (res - 1)

    # ---- the first-plane vertex table, for the previous rank's last-plane faces
    gid_pad = res * res * res * 7
    first = torch.nonzero(p0[:, 0] == x0).reshape(-1)
    n_halo = torch.tensor(first.numel(), **lt)
    first = first[:halo_cap]
    table = torch.stack([torch.full((halo_cap,), gid_pad, **lt),
                         torch.zeros((halo_cap,), **lt)], dim=-1)
    table[:first.numel(), 0] = edge_gids[first]
    table[:first.numel(), 1] = r * v_cap + first
    table = ppermute(table, mesh, -1)
    h_gid, h_slot = table[:, 0].contiguous(), table[:, 1]

    # ---- faces: real cubes × 6 tets × ≤ 2 triangles
    face_src_ok = (cpos <= res - 2).all(-1)
    tets = torch.as_tensor(_TETS, **lt)
    corner_in = ((case8[:, None, None] >> tets[None]) & 1) == 0
    tet_case = sum(corner_in[..., v].long() << v for v in range(4))
    counts = torch.as_tensor(_TRI_COUNT_NP, **lt)[torch.arange(6, device=dev)[None, :], tet_case]
    tri_valid = (torch.arange(2, device=dev)[None, None, :] < counts[:, :, None]) \
        & face_src_ok[:, None, None]
    face_slots = torch.nonzero(tri_valid.reshape(-1)).reshape(-1)
    n_faces = torch.tensor(face_slots.numel(), **lt)
    face_slots = face_slots[:f_cap]
    nf = face_slots.numel()
    fcube = face_slots // 12
    frem = face_slots % 12
    ftet, fk = frem // 2, frem % 2
    fcase = tet_case[fcube, ftet]
    ftris = torch.as_tensor(_TRI_TABLE_NP, **lt)[ftet, fcase, fk].clamp_min(0)
    a = _EDGE_ANCHOR_NP
    geid_delta = torch.as_tensor(
        ((a[..., 0] * res + a[..., 1]) * res + a[..., 2]) * 7 + _EDGE_CLASS_NP, **lt)
    flat = (cube_gids[fcube][:, None] * 7 + geid_delta[ftet[:, None], ftris]).reshape(-1)
    local = flat < (x0 + nloc) * res * res * 7
    v_local = r * v_cap + torch.searchsorted(edge_gids, flat, side="left").clamp_max(v_cap - 1)
    v_remote = h_slot[torch.searchsorted(h_gid, flat, side="left").clamp_max(halo_cap - 1)]
    faces = torch.zeros((f_cap, 3), **lt)
    faces[:nf] = torch.where(local, v_local, v_remote).reshape(-1, 3)

    overflow = ((n_cubes - c_cap).clamp_min(0) + (n_verts - v_cap).clamp_min(0)
                + (n_faces - f_cap).clamp_min(0) + (n_halo - halo_cap).clamp_min(0))
    return MeshResult(
        verts=verts, faces=faces,
        n_verts=psum(torch.tensor(nv, **lt), mesh), n_faces=psum(torch.tensor(nf, **lt), mesh),
        vert_valid=torch.arange(v_cap, device=dev) < nv,
        face_valid=torch.arange(f_cap, device=dev) < nf,
        overflow=psum(overflow, mesh))


def stitch(m: MeshResult, mesh: DeviceMesh) -> MeshResult:
    """The whole mesh on every rank from the ranks' blocks: the vertices
    gathered (differentiable), the faces and the validity gathered."""
    return m._replace(verts=all_gather(m.verts, mesh), faces=all_gather(m.faces, mesh),
                      vert_valid=all_gather(m.vert_valid, mesh),
                      face_valid=all_gather(m.face_valid, mesh))

