"""Sharded Gaussian splatting: per-rank binning, one exchange of tile lists,
tile-block compositing.

Counterpart of dgmesh_tpu/parallel/sharded_splat.py (``render_sharded``
:183, ``_local_bins`` :54, ``_exchange_and_merge`` :97):

  1. each rank preprocesses and bins only its own N/n Gaussians, its depth
     keys quantized against the global depth range (``pmin``/``pmax``), with
     a per-rank duplicate capacity of 2·max_dup/n (at least 1024, at most
     max_dup) for the skew of Gaussians over the image;
  2. one ``all_to_all`` sends each tile block [r·Tn, (r+1)·Tn) its top-K
     rows from every rank with their compositing attributes (Tn = ⌈T/n⌉,
     the tile axis padded to n·Tn), and one more their merge keys;
  3. each rank merges the n depth-sorted lists of each of its tiles with a
     stable sort on (``merge_depth_rank``, global id), truncates to K, and
     composites its block through kernels 1/2 with ``tile0 = r·Tn``.

The merge key orders a tile's rows as the single-device packed key does,
and each rank's top K hold every one of its rows that the global top K can
hold, so the merged lists are the single-device lists, row for row (tested
in tests/test_torch_parallel.py).  The image is gathered on every rank.
"""

from __future__ import annotations

import torch

from ..ops.binning import bin_rects, depth_range, merge_depth_rank, quantize_depth
from ..ops.splat import SplatConfig, _pack_attrs, _tile_rects, preprocess, untile
from ..ops.splat_kernels import LANES, CompositeTiles
from .sharding import DeviceMesh, all_gather, all_to_all, pmax, pmin, psum

BIG = 1 << 30   # sort-last key of an empty candidate slot


def per_rank_dup(max_dup: int, n: int) -> int:
    """A rank's duplicate capacity: 2·max_dup/n with a floor of 1024, at most
    max_dup (JAX's skew headroom)."""
    return min(max_dup, max(2 * max_dup // n, 1024))


def local_bins(pre: dict, cfg: SplatConfig, mesh: DeviceMesh):
    """Bin the rank's Gaussians, depth keys on the global range.  Returns the
    local tile lists (T,K) (-1 padded), the merge depth ranks (N_l,) and the
    counters: the rank's duplicates and duplicate overflow, and the global
    tile overflow (from the per-tile counts summed over the ranks)."""
    valid = pre["valid"]
    depth = pre["depth"].detach()
    dmin, dmax = depth_range(depth, valid)
    dkey = quantize_depth(depth, valid, dmin=pmin(dmin, mesh), dmax=pmax(dmax, mesh))
    tx0, ty0, nx, ny = _tile_rects(pre["mean2d"].detach(), pre["radius"].detach(), valid, cfg)
    bins = bin_rects(tx0, ty0, nx, ny, dkey, valid, tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                     max_dup=per_rank_dup(cfg.max_dup, mesh.world),
                     max_per_tile=cfg.max_per_tile)
    total = psum(bins.tile_count, mesh)
    aux = dict(num_duplicates=bins.num_duplicates, dup_overflow=bins.dup_overflow,
               tile_overflow=(total - cfg.max_per_tile).clamp_min(0).sum())
    return bins.tile_idx, merge_depth_rank(dkey, cfg.num_tiles), aux


def exchange_and_merge(tile_idx, dq, rows, lanes: int, num_tiles: int, K: int,
                       mesh: DeviceMesh):
    """Send each tile block its candidate rows, merge, truncate to K.

    tile_idx (T,K) local row ids (-1 padded), dq (N_l,) merge depth ranks,
    rows (N_l, lanes) the tile rows' attributes (lane 9 the valid flag).
    Returns the rank's block (Tn,K,lanes) and the global ids of its rows
    (Tn,K) (-1 padded), Tn = ⌈T/n⌉."""
    n, r = mesh.world, mesh.rank
    Tn = -(-num_tiles // n)
    Tpad = Tn * n
    dev = rows.device
    if Tpad != num_tiles:
        tile_idx = torch.cat([tile_idx, tile_idx.new_full((Tpad - num_tiles, K), -1)])
    flat = tile_idx.reshape(-1)
    slots = torch.nonzero(flat >= 0).squeeze(1)
    li = flat[slots]
    table = rows.new_zeros((Tpad * K, lanes))
    table[slots] = rows[li]            # only the valid slots are gathered
    keys = torch.full((Tpad * K, 2), BIG, dtype=torch.long, device=dev)
    keys[slots, 0] = dq[li]
    keys[slots, 1] = li + r * rows.shape[0]
    # block j of the tile axis goes to rank j; block i received came from rank i
    cand = all_to_all(table, mesh).reshape(n, Tn, K, lanes)
    ck = all_to_all(keys, mesh).reshape(n, Tn, K, 2)
    cand = cand.permute(1, 0, 2, 3).reshape(Tn, n * K, lanes)
    ck = ck.permute(1, 0, 2, 3).reshape(Tn, n * K, 2)
    # two keys in one: depth rank above the global id (both < 2^31)
    key = (ck[..., 0] << 31) | ck[..., 1]
    key_s, perm = torch.sort(key, dim=1, stable=True)
    perm_k = perm[:, :K]
    block = torch.take_along_dim(cand, perm_k[..., None], dim=1)
    gid = torch.where(key_s[:, :K] < (BIG << 31), key_s[:, :K] & ((1 << 31) - 1), -1)
    return block.contiguous(), gid


def render_sharded(mesh: DeviceMesh, means3d, scales, quats, opacities, shs, alive, cam,
                   bg_color, cfg: SplatConfig, sh_degree: int, screen_offset=None):
    """The sharded twin of ops/splat.py::render: the same returns, with the
    rank's rows of the Gaussian inputs (N/n each) and the whole image on
    every rank.  ``radii`` and ``visibility`` are the rank's rows; the
    counters are global."""
    pre = preprocess(means3d, scales, quats, opacities, shs, alive, cam, cfg, sh_degree)
    if screen_offset is not None:
        pre = dict(pre, mean2d=pre["mean2d"] + screen_offset)
    tile_idx, dq, aux = local_bins(pre, cfg, mesh)
    packed = _pack_attrs(pre)
    rows = torch.cat([packed, packed.new_ones((packed.shape[0], 1)),
                      packed.new_zeros((packed.shape[0], LANES - 10))], dim=-1)
    block, _ = exchange_and_merge(tile_idx, dq, rows, LANES, cfg.num_tiles, cfg.max_per_tile,
                                  mesh)
    Tn = block.shape[0]
    rgb, alpha = CompositeTiles.apply(block, cfg.tiles_x, cfg.tile_h, cfg.tile_w,
                                      mesh.rank * Tn)
    rgb = all_gather(rgb, mesh)[:cfg.num_tiles]
    alpha = all_gather(alpha, mesh)[:cfg.num_tiles]
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    out = rgb + (1.0 - alpha)[..., None] * bg[None, None, :]
    geo = (cfg.tiles_x, cfg.tiles_y, cfg.tile_h, cfg.tile_w, cfg.height, cfg.width)
    aux = dict(num_duplicates=psum(aux["num_duplicates"], mesh),
               dup_overflow=psum(aux["dup_overflow"], mesh),
               tile_overflow=aux["tile_overflow"])
    return dict(render=untile(out, *geo).permute(2, 0, 1), alpha=untile(alpha, *geo),
                radii=pre["radius"], visibility=pre["valid"], aux=aux)
