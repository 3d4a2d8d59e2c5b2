"""Sharded mesh rasterization: per-rank face binning, one exchange of tile
lists, tile-block shading.

Counterpart of dgmesh_tpu/parallel/sharded_mr.py (``render_mesh_sharded``
:130, ``_local_face_bins`` :47, ``_exchange_and_merge`` :82), by the recipe
of parallel/sharded_splat.py: each rank projects and bins only its own
faces (a block of the face axis: the sharded marching tets' own block), the
24-lane shading rows (screen triangle, 1/w, valid, corner colours, global
face id) go to the rank that owns their tile block, each rank merges its
tiles' lists on (``merge_depth_rank``, global face id), truncates to K and
shades its block through kernels 3/4 with ``tile0``.  The vertices and
their colours are replicated (their gradients are partial on each rank and
sum over the ranks, parallel/sharding.py); the image is gathered.
"""

from __future__ import annotations

import torch

from ..ops.binning import bin_rects, depth_range, merge_depth_rank, quantize_depth, rect_from_bbox
from ..ops.mesh_raster import MeshRasterConfig, _face_screen, _untile
from ..ops.mesh_raster_kernels import LANES, ShadeTiles
from .sharded_splat import exchange_and_merge, per_rank_dup
from .sharding import DeviceMesh, all_gather, pmax, pmin, psum


def local_face_bins(tri, inv_w, fvalid, cfg: MeshRasterConfig, mesh: DeviceMesh):
    """Bin the rank's faces as ops/mesh_raster.py::rasterize does, depth keys
    on the global range.  Returns (tile_idx (T,K), merge depth ranks (F_l,),
    the counters, the culled validity)."""
    tri_s = tri.detach()
    if cfg.cull_backface:
        e1 = tri_s[:, 1] - tri_s[:, 0]
        e2 = tri_s[:, 2] - tri_s[:, 0]
        fvalid = fvalid & (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0.0)
    pad = 1.0
    x0 = torch.floor(tri_s[..., 0].amin(1) - pad)
    x1 = torch.ceil(tri_s[..., 0].amax(1) + pad)
    y0 = torch.floor(tri_s[..., 1].amin(1) - pad)
    y1 = torch.ceil(tri_s[..., 1].amax(1) + pad)
    tx0, ty0, nx, ny = rect_from_bbox(x0, y0, x1, y1, tile_w=cfg.tile_w, tile_h=cfg.tile_h,
                                      tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y)
    depth = 1.0 / torch.clamp_min(inv_w.detach().mean(dim=1), 1e-6)
    dmin, dmax = depth_range(depth, fvalid)
    dkey = quantize_depth(depth, fvalid, dmin=pmin(dmin, mesh), dmax=pmax(dmax, mesh))
    bins = bin_rects(tx0, ty0, nx, ny, dkey, fvalid, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                     max_dup=per_rank_dup(cfg.max_dup, mesh.world),
                     max_per_tile=cfg.max_per_tile)
    total = psum(bins.tile_count, mesh)
    aux = dict(num_duplicates=bins.num_duplicates, dup_overflow=bins.dup_overflow,
               tile_overflow=(total - cfg.max_per_tile).clamp_min(0).sum())
    return bins.tile_idx, merge_depth_rank(dkey, cfg.num_tiles), aux


def render_mesh_sharded(mesh: DeviceMesh, verts, faces, face_valid, vtx_color, pose, proj,
                        bg_color, cfg: MeshRasterConfig, want_soft: bool = True, tri_w=None):
    """The sharded twin of ops/mesh_raster.py::render_mesh.  ``verts`` (V,3)
    and ``vtx_color`` (V,3) are the whole (replicated) mesh's; ``faces``
    (F_l,3) and ``face_valid`` are the rank's block of the face axis (block
    ``mesh.rank`` of n equal blocks), ``tri_w`` optionally its pre-gathered
    ``verts[faces]``.  Returns what render_mesh returns, whole on every
    rank, the counters global."""
    F_l = faces.shape[0]
    if tri_w is None:
        tri_w = verts[faces]
    tri, inv_w, fvalid = _face_screen(verts, faces, face_valid, pose, proj, cfg, tri_w)
    tile_idx, dq, aux = local_face_bins(tri, inv_w, fvalid, cfg, mesh)
    # the 24-lane rows of the rank's faces; lane 19 the global face id.  The
    # corner colours of the valid faces only: the padding faces all point at
    # vertex 0, and their gather's backward would pile on it
    gfid = mesh.rank * F_l + torch.arange(F_l, device=verts.device)
    live = torch.nonzero(face_valid).squeeze(1)
    colors = vtx_color.new_zeros((F_l, 9))
    colors[live] = vtx_color[faces[live]].reshape(-1, 9)
    rows = torch.cat([tri.reshape(-1, 6), inv_w, torch.ones_like(inv_w[:, :1]), colors,
                      gfid[:, None].float(), inv_w.new_zeros((F_l, LANES - 20))], dim=-1)
    block, _ = exchange_and_merge(tile_idx, dq, rows, LANES, cfg.num_tiles, cfg.max_per_tile,
                                  mesh)
    Tn = block.shape[0]
    rgb, hard, soft, fid = ShadeTiles.apply(block, cfg.tiles_x, cfg.tile_h, cfg.tile_w,
                                            cfg.sigma, mesh.rank * Tn)
    T = cfg.num_tiles
    rgb, soft = all_gather(rgb, mesh)[:T], all_gather(soft, mesh)[:T]
    hard, fid = all_gather(hard, mesh)[:T], all_gather(fid, mesh)[:T]
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=verts.device)
    rgb = rgb + (1.0 - hard)[..., None] * bg[None, None, :]
    fid_out = torch.where(hard > 0.5, fid.long(), -1)
    out = dict(rgb=_untile(rgb, cfg), mask=_untile(hard, cfg), face_id=_untile(fid_out, cfg),
               aux=dict(num_duplicates=psum(aux["num_duplicates"], mesh),
                        dup_overflow=psum(aux["dup_overflow"], mesh),
                        tile_overflow=aux["tile_overflow"]))
    if want_soft:
        soft = _untile(soft, cfg)
        out["soft_mask"] = soft
        out["st_mask"] = out["mask"].detach() + (soft - soft.detach())
    return out
