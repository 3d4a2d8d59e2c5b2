"""Tile binning: map N screen-space rectangles to per-tile item lists.

Counterpart of dgmesh_tpu/ops/binning.py, shared by the Gaussian splatter and
the mesh rasterizer.  The JAX version builds the duplicate list gather-only
(stamp + cummax, tril-matmul prefix sums) for the TPU; here it is
``torch.repeat_interleave`` + ``torch.sort(stable=True)`` +
``torch.searchsorted``.  What matches the JAX version exactly:

  * slot order: items in id order, each item's tiles row-major over its rect;
  * truncation to the first ``max_dup`` slots;
  * the packed int32 key ``tile << depth_bits | dq``;
  * the stable sort, and nearest-K truncation per tile;
  * the counters ``num_duplicates``, ``dup_overflow``, ``tile_overflow``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TileBins(NamedTuple):
    tile_idx: torch.Tensor        # (num_tiles, K) int64 item ids, -1 padded
    num_duplicates: torch.Tensor  # () pre-truncation (item, tile) pairs
    dup_overflow: torch.Tensor    # () pairs beyond max_dup
    tile_overflow: torch.Tensor   # () entries beyond K, summed over tiles
    tile_count: torch.Tensor      # (num_tiles,) entries per tile before K


def _depth_bits(num_tiles: int) -> int:
    """Depth bits available in the packed (tile|depth) int32 sort key."""
    tile_bits = max(int(num_tiles + 1).bit_length(), 1)
    depth_bits = min(31 - tile_bits, 14)
    assert depth_bits >= 8, f"too many tiles ({num_tiles}) for packed keys"
    return depth_bits


def bin_rects(tx0, ty0, nx, ny, depth_key, valid, *, tiles_x: int,
              tiles_y: int, max_dup: int, max_per_tile: int) -> TileBins:
    """All inputs (N,): tile rects (int), depth_key (int32), valid (bool)."""
    dev = tx0.device
    num_tiles = tiles_x * tiles_y
    count = torch.where(valid, nx * ny, 0).long()
    total = count.sum()
    n_slots = min(int(total), max_dup)

    # slot → owning item, in item order; each item's tiles row-major
    g = torch.repeat_interleave(torch.arange(count.shape[0], device=dev), count)[:n_slots]
    start = torch.cumsum(count, 0) - count
    k = torch.arange(n_slots, device=dev) - start[g]
    nx_g = nx[g].long().clamp_min(1)
    tile = (ty0[g].long() + k // nx_g) * tiles_x + (tx0[g].long() + k % nx_g)

    depth_bits = _depth_bits(num_tiles)
    dq = (depth_key[g].long() >> 16).clamp(0, (1 << 14) - 1)
    dq = (dq >> (14 - depth_bits)).clamp(0, (1 << depth_bits) - 1)
    key = (tile << depth_bits) | dq
    key_s, perm = torch.sort(key, stable=True)
    g_s = g[perm]

    tids = torch.arange(num_tiles, device=dev)
    t_start = torch.searchsorted(key_s, tids << depth_bits, side="left")
    t_end = torch.searchsorted(key_s, (tids + 1) << depth_bits, side="left")

    pos = t_start[:, None] + torch.arange(max_per_tile, device=dev)[None, :]
    in_range = pos < t_end[:, None]
    pos = pos.clamp_max(max(n_slots - 1, 0))
    if n_slots:
        tile_idx = torch.where(in_range, g_s[pos], -1)
    else:
        tile_idx = torch.full((num_tiles, max_per_tile), -1, dtype=torch.long, device=dev)

    cnt = t_end - t_start
    return TileBins(tile_idx=tile_idx, num_duplicates=total,
                    dup_overflow=(total - max_dup).clamp_min(0),
                    tile_overflow=(cnt - max_per_tile).clamp_min(0).sum(),
                    tile_count=cnt)


def rect_from_bbox(x0, y0, x1, y1, *, tile_w: int, tile_h: int,
                   tiles_x: int, tiles_y: int):
    """Pixel-space bbox → touched tile rect (clamped, like auxiliary.h getRect).

    The float → int casts truncate toward zero (like ``astype(int32)``); the
    float ``//`` floors (like ``jnp.floor_divide``)."""
    tx0 = (x0 / tile_w).clamp(0, tiles_x).to(torch.int32)
    ty0 = (y0 / tile_h).clamp(0, tiles_y).to(torch.int32)
    tx1 = torch.div(x1 + tile_w - 1, tile_w, rounding_mode="floor").clamp(0, tiles_x).to(torch.int32)
    ty1 = torch.div(y1 + tile_h - 1, tile_h, rounding_mode="floor").clamp(0, tiles_y).to(torch.int32)
    nx = (tx1 - tx0).clamp_min(0)
    ny = (ty1 - ty0).clamp_min(0)
    return tx0, ty0, nx, ny


def depth_range(depth: torch.Tensor, valid: torch.Tensor):
    """Masked (min, max) of depth, the range quantize_depth normalises by; the
    multi-device path reduces it over the ranks (parallel/sharded_splat.py)."""
    return (torch.where(valid, depth, float("inf")).min(),
            torch.where(valid, depth, float("-inf")).max())


def merge_depth_rank(depth_key: torch.Tensor, num_tiles: int) -> torch.Tensor:
    """Per-item depth rank at the resolution ``bin_rects`` sorts by: with the
    global item id as the tie-break, it orders a tile's items as the packed
    key does, so per-rank top-K lists merge into the single-device list
    exactly (dgmesh_tpu/ops/binning.py::merge_depth_rank)."""
    depth_bits = _depth_bits(num_tiles)
    dq = (depth_key.long() >> 16).clamp(0, (1 << 14) - 1)
    return (dq >> (14 - depth_bits)).clamp(0, (1 << depth_bits) - 1)


def quantize_depth(depth: torch.Tensor, valid: torch.Tensor, bits: int = 30,
                   dmin=None, dmax=None) -> torch.Tensor:
    """Map float depth to monotone int32 keys over the valid depth range, or
    over ``dmin``/``dmax`` where given (the ranks' common range)."""
    if dmin is None or dmax is None:
        dmin, dmax = depth_range(depth, valid)
    drange = torch.clamp_min(dmax - dmin, 1e-6)
    q = (depth - dmin) / drange * float(1 << bits)
    # invalid items (count 0) may hold non-finite or out-of-range depths; they
    # are never binned, so give them a defined key before the int cast
    q = torch.where(valid & torch.isfinite(q), q, 0.0)
    return q.to(torch.int32)
