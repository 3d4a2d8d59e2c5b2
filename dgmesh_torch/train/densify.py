"""Structural Gaussian-set operations on the padded buffers.

Counterpart of dgmesh_tpu/train/densify.py (reference
gaussian_model_dpsr_dynamic_anchor.py: densify_and_clone :500-517,
densify_and_split :471-498, prune :531-545, densify_and_prune :546-556,
reset_opacity :291-294, normal_initialization :684-734, anchor_mesh
:736-828 with average_and_prune :599-649 and densify_from_face :651-677).

Slot model, as in JAX: capacity-M tensors and an ``alive`` mask.  "Append"
writes into free slots (the first ones, ``torch.nonzero`` order);
"delete" clears the mask; every slot a structural op touches gets zero
Adam moments.  Each function returns new tensors and never writes into its
inputs.  Where JAX writes with ``.at[idx].set(..., mode="drop")`` and an
out-of-range index M for the dropped rows, the rows are masked first and
only the kept ones written (their destinations are distinct).

The random draws (the split's normals, the anchor's scores and spawn
angles, the surface samples) come from a ``torch.Generator``, or are given
as arguments: jax.random cannot be reproduced in torch, and the parity
tests pass JAX's own draws.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from .. import tracing
from ..config import Config
from ..models import gaussians as G
from ..models.gaussians import GaussianParams, GaussianStats, inverse_sigmoid
from ..ops.knn import knn, mean_knn_dist2
from ..ops.laplacian import face_centroids, face_normals
from ..ops.marching_tets import MTConfig, marching_tets
from ..ops.occupancy import gaussian_occupancy_grid, sample_mesh_surface
from ..ops.quaternion import quat_to_rotmat

PER_GAUSS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity", "normal")
PERCENT_DENSE = 0.01   # reference arguments/__init__.py:126


def _zero_moments_at(mu: GaussianParams, nu: GaussianParams, mask: torch.Tensor):
    """Both Adam moments zeroed at the slots of ``mask`` (M,), per-Gaussian leaves."""
    def z(tree):
        return tree._replace(**{
            n: torch.where(mask.reshape((-1,) + (1,) * (getattr(tree, n).dim() - 1)), 0.0,
                           getattr(tree, n)) for n in PER_GAUSS})
    return z(mu), z(nu)


def _copy_rows(gp: GaussianParams, src: torch.Tensor, dst: torch.Tensor,
               values: Optional[Dict[str, torch.Tensor]] = None) -> GaussianParams:
    """gp[dst] = values[name] (or gp[src]) for every per-Gaussian leaf; src,
    dst and the rows of values are the kept rows only, dst distinct."""
    out = {}
    for n in PER_GAUSS:
        arr = getattr(gp, n).clone()
        arr[dst] = arr[src] if values is None or n not in values else values[n]
        out[n] = arr
    return gp._replace(**out)


def _mark(M: int, idx: torch.Tensor, device) -> torch.Tensor:
    m = torch.zeros(M, dtype=torch.bool, device=device)
    m[idx] = True
    return m


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)


@tracing.span("step.densify")
@torch.no_grad()
def densify_and_prune(cfg: Config, gp: GaussianParams, gs: GaussianStats, mu: GaussianParams,
                      nu: GaussianParams, extent, use_size_threshold: bool,
                      gen: Optional[torch.Generator] = None, split_normals=None):
    """reference densify_and_prune :546-556: clone the small Gaussians whose
    view-space gradient reached the threshold into free slots, split the
    big ones (child 0 in the parent's slot, child 1 in a free one), prune
    by opacity (and, with ``use_size_threshold``, by screen radius and
    world size), zero the moments of every touched slot and reset the
    densify statistics.

    ``split_normals``: the two (M,3) standard-normal draws of the split
    (row j for the j-th split source), from ``gen`` unless given.
    Returns (gp, gs, mu, nu, counts) with counts {"clone", "split",
    "prune"} () int64 tensors."""
    o = cfg.optimization
    M, dev = gp.xyz.shape[0], gp.xyz.device
    extent = torch.as_tensor(extent, dtype=torch.float32, device=dev)
    grads = torch.where(gs.denom > 0, gs.xyz_grad_accum / torch.clamp_min(gs.denom, 1), 0.0)
    scale_act = G.get_scaling(gp)
    maxscale = scale_act.amax(-1)
    hit = gs.alive & (grads >= o.densify_grad_threshold)

    # ---- clone (small Gaussians copied into free slots) :500-517
    clone_sel = hit & (maxscale <= PERCENT_DENSE * extent)
    src_c = torch.nonzero(clone_sel).reshape(-1)
    free_c = torch.nonzero(~gs.alive).reshape(-1)
    n_clone = min(src_c.numel(), free_c.numel())
    src_c, free_c = src_c[:n_clone], free_c[:n_clone]
    gp = _copy_rows(gp, src_c, free_c)
    alive = gs.alive.clone()
    alive[free_c] = True

    # ---- split (big Gaussians → 2 children, the parent's slot reused) :471-498
    split_sel = hit & (maxscale > PERCENT_DENSE * extent)
    src_s = torch.nonzero(split_sel).reshape(-1)
    free_s = torch.nonzero(~alive).reshape(-1)
    n_split = min(src_s.numel(), free_s.numel())
    src_s, free_s = src_s[:n_split], free_s[:n_split]
    if split_normals is None:
        split_normals = [torch.randn((M, 3), generator=gen, device=dev) for _ in range(2)]
    stds = scale_act[src_s]
    rots = quat_to_rotmat(gp.rotation[src_s])
    child = []
    for z in split_normals:
        off = torch.einsum("nij,nj->ni", rots, z.to(dev)[:n_split] * stds)
        child.append(dict(xyz=gp.xyz[src_s] + off,
                          scaling=torch.log(torch.clamp_min(stds / (0.8 * 2), 1e-10))))
    gp = _copy_rows(gp, src_s, src_s, child[0])
    gp = _copy_rows(gp, src_s, free_s, child[1])
    alive[free_s] = True

    # ---- prune :531-545 (the screen radii are the slot's, as in JAX)
    prune = alive & (G.get_opacity(gp).reshape(-1) < cfg.model.prune_threshold)
    if use_size_threshold:
        prune = (prune | (alive & (gs.max_radii2d > 20.0))
                 | (alive & (G.get_scaling(gp).amax(-1) > 0.1 * extent)))
    alive = alive & ~prune

    touched = _mark(M, torch.cat([free_c, src_s, free_s]), dev) | prune
    mu, nu = _zero_moments_at(mu, nu, touched)
    z = torch.zeros(M, dtype=torch.float32, device=dev)
    gs = gs._replace(alive=alive, max_radii2d=z, xyz_grad_accum=z.clone(), denom=z.clone())
    counts = dict(clone=torch.tensor(n_clone), split=torch.tensor(n_split),
                  prune=prune.sum().cpu())
    return gp, gs, mu, nu, counts


@tracing.span("step.densify")
@torch.no_grad()
def reset_opacity(gp: GaussianParams, mu: GaussianParams, nu: GaussianParams):
    """reference reset_opacity :291-294: every opacity to at most 0.01, and
    zero opacity moments."""
    new_op = inverse_sigmoid(torch.clamp_max(G.get_opacity(gp), 0.01))
    return (gp._replace(opacity=new_op), mu._replace(opacity=torch.zeros_like(mu.opacity)),
            nu._replace(opacity=torch.zeros_like(nu.opacity)))


@torch.no_grad()
def normal_initialization(cfg: Config, gp: GaussianParams, gs: GaussianStats, nets, fid,
                          occ_res: int = 256, occ_bbox_scale: float = 2.0,
                          gen: Optional[torch.Generator] = None, u=None, uv=None):
    """reference normal_initialization :684-734: the occupancy grid of the
    deformed Gaussians (nets in float32) → its iso-surface at 0.01 by
    marching tets → M area-weighted surface samples (draws ``u``, ``uv`` as
    in ``sample_mesh_surface``) → each Gaussian takes the normal of its
    nearest sample; density_thres is reset.  Returns (gp, mesh), the mesh's
    vertices in the grid's [0,1]³ (MeshResult)."""
    M, dev = gp.xyz.shape[0], gp.xyz.device
    t_in = torch.as_tensor(fid, dtype=torch.float32, device=dev).reshape(1, 1).expand(M, 1)
    tracing.count("nets.live_rows.deform", lambda: gs.alive.sum())
    d_xyz, d_rot, d_scale, _ = nets.deform(gp.xyz, t_in, "f32")
    pts = gp.xyz + d_xyz
    occ = gaussian_occupancy_grid(pts, G.get_scaling(gp) + d_scale, G.get_rotation(gp) + d_rot,
                                  G.get_opacity(gp), gs.alive, torch.zeros(3, device=dev),
                                  occ_bbox_scale, occ_res)
    t = cfg.tpu
    mt_cfg = MTConfig(res=occ_res, max_verts=t.max_verts, max_faces=t.max_faces,
                      max_cubes=max(t.max_verts, t.max_faces // 2))
    m = marching_tets(0.01 - occ, mt_cfg)      # outside (occ ≈ 0) positive
    verts_w = m.verts * 2.0 * occ_bbox_scale - occ_bbox_scale
    samp, samp_n = sample_mesh_surface(verts_w, m.faces, m.face_valid, M, gen=gen, u=u, uv=uv)
    _, idx = knn(pts, samp, 1)
    normals = _normalize(samp_n[idx[:, 0]])
    gp = gp._replace(
        normal=torch.where(gs.alive[:, None], normals, 0.0),
        density_thres=torch.tensor(cfg.optimization.init_density_threshold,
                                   dtype=torch.float32, device=dev))
    return gp, m


class AnchorInfo(NamedTuple):
    centroid_of_gaussian: torch.Tensor   # (M,3) nearest face centroid per Gaussian
    gauss_1_1_mask: torch.Tensor         # (M,) Gaussians alone in their face (pre-anchor alive)
    loss_n_1: torch.Tensor               # () the n-1 term, a constant (no gradient)
    stats: Dict[str, torch.Tensor]


def _top(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, ties to the lower index (jax.lax.top_k's order)."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


@torch.no_grad()
def anchor_step(cfg: Config, gp: GaussianParams, gs: GaussianStats, mu: GaussianParams,
                nu: GaussianParams, nets, fid, mesh_verts, mesh_faces, face_valid,
                gen: Optional[torch.Generator] = None, draws: Optional[dict] = None):
    """reference anchor_mesh :736-828: every live Gaussian (deformed, nets in
    float32) is assigned its nearest face centroid; those farther than the
    search radius are pruned.  Of the faces with more than one Gaussian, a
    random batch of anchor_n_1_bs merges its first topn members (slot
    order) into one, averaged in deformed space and deformed back, and
    deletes the rest; of the faces with none, a random batch of
    anchor_0_1_bs spawns a Gaussian at each centroid.  Every touched slot
    gets zero moments and the densify statistics are reset.

    ``draws``: {"n_1": (F,) and "0_1": (F,) uniform scores, "angle":
    (anchor_0_1_bs, 1) standard normal}, each from ``gen`` unless given.
    Returns (gp, gs, mu, nu, AnchorInfo).  JAX's quirks are kept: squared
    kNN distances against the unsquared radius; a face with
    1 < count < topn averages its count members."""
    o = cfg.optimization
    M, dev = gp.xyz.shape[0], gp.xyz.device
    F = mesh_faces.shape[0]
    pre_alive = gs.alive
    topn = max(2, int(o.anchor_topn))
    bs, inc = o.anchor_n_1_bs, o.anchor_0_1_bs
    draws = dict(draws or {})
    if "n_1" not in draws:
        draws["n_1"] = torch.rand((F,), generator=gen, device=dev)
    if "0_1" not in draws:
        draws["0_1"] = torch.rand((F,), generator=gen, device=dev)
    if "angle" not in draws:
        draws["angle"] = torch.randn((inc, 1), generator=gen, device=dev)

    fid_t = torch.as_tensor(fid, dtype=torch.float32, device=dev).reshape(1, 1)
    tracing.count("nets.live_rows.deform", lambda: gs.alive.sum())
    d_xyz, d_rot, d_scale, d_norm = nets.deform(gp.xyz, fid_t.expand(M, 1), "f32")
    gpts = gp.xyz + d_xyz
    cent = face_centroids(mesh_verts, mesh_faces, face_valid)
    fnorm = face_normals(mesh_verts, mesh_faces, face_valid)
    with tracing.span("anchor.knn"):
        d2, nn = knn(gpts, cent, 1, ref_valid=face_valid)
    d2, nn = d2[:, 0], nn[:, 0]
    # the reference compares SQUARED distances with the UNsquared radius (:743-765)
    radius = gs.gaussian_scale * o.anchor_search_radius
    alive1 = gs.alive & (d2 < radius)

    counts = torch.bincount(nn[alive1], minlength=F)
    c1 = face_valid & (counts == 1)
    cn = face_valid & (counts > 1)
    c0 = face_valid & (counts == 0)
    g11 = alive1 & c1[nn]

    # ---- n-1 faces: a random batch merges its first topn Gaussians
    sel_f = _top(torch.where(cn, draws["n_1"].to(dev), -math.inf), bs)
    sel_valid = cn[sel_f]
    fsel_mask = _mark(F, sel_f[sel_valid], dev)
    # each Gaussian's rank within its face, by slot order (:795-801)
    gkey = torch.where(alive1, nn, F)
    sorted_key, sorted_gid = torch.sort(gkey, stable=True)
    own_start = torch.searchsorted(sorted_key, gkey)
    pos_sorted = torch.empty(M, dtype=torch.long, device=dev)
    pos_sorted[sorted_gid] = torch.arange(M, device=dev)
    rank = pos_sorted - own_start
    to_delete = alive1 & fsel_mask[nn] & (rank >= topn)       # beyond topn (:802-805)

    f_start = torch.searchsorted(sorted_key, sel_f)
    ks = torch.arange(topn, device=dev)
    gk = sorted_gid[torch.clamp_max(f_start[:, None] + ks[None, :], M - 1)]   # (bs, topn)
    kvalid = sel_valid[:, None] & (ks[None, :] < counts[sel_f][:, None])
    w = kvalid.to(torch.float32)
    w = w / torch.clamp_min(w.sum(1, keepdim=True), 1.0)
    ga = gk[:, 0]

    def gather_mean(arr):
        vals = arr[gk]                                        # (bs, topn, ...)
        return (vals * w.reshape(w.shape + (1,) * (vals.dim() - 2))).sum(1)

    # average in deformed space, then deform back (average_and_prune :599-649)
    sel_t = fid_t.expand(sel_f.shape[0], 1)
    mdef_xyz = gather_mean(gpts)
    mdef_scaling = gather_mean(gp.scaling + d_scale)
    mdef_rot = gather_mean(gp.rotation + d_rot)
    mdef_norm = gather_mean(gp.normal + d_norm)
    tracing.count("nets.live_rows.deform_back", lambda: sel_valid.sum())
    db_xyz, db_rot, db_scale, db_norm = nets.deform_back(mdef_xyz, sel_t, "f32")
    loss_n_1 = (torch.where(sel_valid, torch.linalg.norm(cent[sel_f] - mdef_xyz, dim=-1), 0.0)
                .sum() / torch.clamp_min(sel_valid.sum(), 1))
    merged = dict(xyz=mdef_xyz + db_xyz, scaling=mdef_scaling + db_scale,
                  rotation=mdef_rot + db_rot, normal=_normalize(mdef_norm + db_norm),
                  f_dc=gather_mean(gp.f_dc), f_rest=gather_mean(gp.f_rest),
                  opacity=gather_mean(gp.opacity))
    ga_kept = ga[sel_valid]
    gp = _copy_rows(gp, ga_kept, ga_kept, {n: v[sel_valid] for n, v in merged.items()})
    killed = _mark(M, gk[:, 1:][kvalid[:, 1:]], dev)         # members beyond slot 0
    alive2 = alive1 & ~to_delete & ~killed

    # ---- 0-1 faces: spawn at centroids (densify_from_face :651-677)
    sel0 = _top(torch.where(c0, draws["0_1"].to(dev), -math.inf), inc)
    sel0_valid = c0[sel0]
    sp_xyz = cent[sel0]
    sp_norm = fnorm[sel0]
    # scale: kNN among the spawned batch (the reference's distCUDA2 on it)
    sd2 = torch.clamp_min(mean_knn_dist2(sp_xyz, sel0_valid, k=3), 1e-7)
    sp_scaling = torch.log(torch.sqrt(sd2))[:, None] * torch.ones((1, 3), device=dev)
    half = draws["angle"].to(dev) * 2 * math.pi / 2.0
    sp_rot = torch.cat([torch.cos(half), _normalize(sp_norm) * torch.sin(half)], -1)
    tracing.count("nets.live_rows.deform_back", lambda: sel0_valid.sum())
    sb_xyz, sb_rot, sb_scale, sb_norm = nets.deform_back(sp_xyz, fid_t.expand(sel0.shape[0], 1),
                                                         "f32")
    n_sp = sel0.shape[0]
    sp_vals = dict(
        xyz=sp_xyz + sb_xyz, scaling=sp_scaling + sb_scale, rotation=sp_rot + sb_rot,
        normal=_normalize(sp_norm + sb_norm),
        f_dc=torch.ones((n_sp, 1, 3), device=dev),
        f_rest=torch.zeros((n_sp,) + tuple(gp.f_rest.shape[1:]), device=dev),
        opacity=torch.full((n_sp, 1), float(inverse_sigmoid(torch.tensor(0.1))), device=dev))
    # the valid spawns, packed to the front, into the first free slots
    free_idx = torch.nonzero(~alive2).reshape(-1)
    spawn_rows = torch.nonzero(sel0_valid).reshape(-1)
    n_spawn = min(spawn_rows.numel(), free_idx.numel())
    dst = free_idx[:n_spawn]
    rows = spawn_rows[:n_spawn]
    gp = _copy_rows(gp, dst, dst, {n: v[rows] for n, v in sp_vals.items()})
    alive3 = alive2.clone()
    alive3[dst] = True

    touched = (killed | to_delete | (alive1 & ~alive2) | _mark(M, torch.cat([ga_kept, dst]), dev)
               | (pre_alive & ~alive1))                       # the last: radius-pruned
    mu, nu = _zero_moments_at(mu, nu, touched)
    z = torch.zeros(M, dtype=torch.float32, device=dev)
    gs = gs._replace(alive=alive3, max_radii2d=z, xyz_grad_accum=z.clone(), denom=z.clone())
    info = AnchorInfo(
        centroid_of_gaussian=cent[nn], gauss_1_1_mask=g11, loss_n_1=loss_n_1,
        stats=dict(n_alive_after=alive3.sum(), n_pruned_radius=(pre_alive & ~alive1).sum(),
                   n_merged=sel_valid.sum(), n_spawned=torch.tensor(n_spawn, device=dev),
                   hit_1_1=c1.sum(), faces=face_valid.sum()))
    return gp, gs, mu, nu, info

