"""Exact k-nearest-neighbour mean distance, row-chunked.

Counterpart of dgmesh_tpu/ops/knn.py::mean_knn_dist2 (reference simple-knn
distCUDA2, spatial.cu:16-26).  Exact: each chunk of queries meets every
reference point; chunking bounds the (chunk, N) distance block, since an
unchunked 100k × 100k float32 matrix would take 40 GB.
"""

from __future__ import annotations

import torch


def mean_knn_dist2(points: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, per point (N,).

    With fewer than k other points, the missing neighbours count as 0, as in
    the JAX version.
    """
    n = points.shape[0]
    r2 = (points * points).sum(-1)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for s in range(0, n, chunk):
        q = points[s:s + chunk]
        # same expansion as the JAX version: ‖q‖² + ‖r‖² − 2 q·r, clamped at 0
        d2 = (r2[s:s + chunk, None] + r2[None, :] - 2.0 * (q @ points.T)).clamp_min(0.0)
        rows = torch.arange(q.shape[0], device=points.device)
        d2[rows, rows + s] = float("inf")                  # exclude self
        best = torch.topk(d2, min(k, n), dim=1, largest=False).values
        best = torch.where(torch.isfinite(best), best, 0.0)
        out[s:s + chunk] = best.mean(-1)
    return out
