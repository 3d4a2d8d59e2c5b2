"""Exact k-nearest-neighbour search, blocked over the queries.

Counterpart of dgmesh_tpu/ops/knn.py (reference simple-knn distCUDA2,
spatial.cu:16-26, and pytorch3d knn_points in anchor_mesh :760 and
normal_initialization :719).  Exact: each block of queries meets every
valid reference point.  Distances are the JAX version's expansion
‖q‖² + ‖r‖² − 2 q·r, clamped at 0 (not ``torch.cdist``, whose rounding
differs near the anchor radius).  The references are compacted to the
valid ones first and the indices mapped back; the query block is sized so
that one (block, refs) float32 distance block stays near BLOCK_BYTES
(131,072 queries against ~960k mesh faces would take 500 GB at once).
"""

from __future__ import annotations

from typing import Optional

import torch

BLOCK_BYTES = 1 << 30


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int,
        ref_valid: Optional[torch.Tensor] = None, exclude_self: bool = False,
        chunk: Optional[int] = None):
    """Squared distances (Q,k) and indices (Q,k) int64 of the k nearest refs
    (R,3) to each query (Q,3), nearest first.

    Invalid refs (``ref_valid`` False) count as +inf, and so does the ref
    of a query's own index with ``exclude_self`` (self-kNN where queries is
    refs); a missing neighbour is (+inf, 0).  With k = 1 a tie goes to the
    lowest index, as in JAX; for k > 1 ``torch.topk`` orders ties.  ``chunk``
    fixes the queries per block."""
    Q, dev = queries.shape[0], queries.device
    ids = None if ref_valid is None else torch.nonzero(ref_valid).reshape(-1)
    r = refs if ids is None else refs[ids]
    R = r.shape[0]
    best_d = torch.full((Q, k), float("inf"), dtype=queries.dtype, device=dev)
    best_i = torch.zeros((Q, k), dtype=torch.long, device=dev)
    if R == 0 or Q == 0:
        return best_d, best_i
    kk = min(k, R)
    r2 = (r * r).sum(-1)
    rows = chunk or max(1, BLOCK_BYTES // (4 * R))
    ref_ids = torch.arange(R, device=dev) if ids is None else ids
    for s in range(0, Q, rows):
        q = queries[s:s + rows]
        # the JAX version's order: (‖q‖² + ‖r‖²) − 2 q·r, then clamp at 0
        d2 = (q * q).sum(-1, keepdim=True) + r2[None, :]
        d2.sub_(q @ r.T, alpha=2.0).clamp_min_(0.0)
        if exclude_self:
            own = torch.arange(s, s + q.shape[0], device=dev)[:, None] == ref_ids[None, :]
            d2.masked_fill_(own, float("inf"))
        if kk == 1:
            v, i = torch.min(d2, dim=1, keepdim=True)       # first index of a tie
        else:
            v, i = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        best_d[s:s + rows, :kk] = v
        best_i[s:s + rows, :kk] = torch.where(torch.isfinite(v), ref_ids[i], 0)
        del d2
    return best_d, best_i


def mean_knn_dist2(points: torch.Tensor, valid: Optional[torch.Tensor] = None, k: int = 3,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, per point (N,).

    With ``valid``, invalid points are ignored as neighbours and a missing
    neighbour counts as 0, as in the JAX version."""
    d2, _ = knn(points, points, k, ref_valid=valid, exclude_self=True, chunk=chunk)
    if valid is not None:
        d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return d2.mean(-1)
