"""Exact k-nearest-neighbour search: a CUDA kernel for k = 1, a blocked twin.

Counterpart of dgmesh_tpu/ops/knn.py (reference simple-knn distCUDA2,
spatial.cu:16-26, and pytorch3d knn_points in anchor_mesh :760 and
normal_initialization :719).  Exact: each query meets every valid
reference point.  Distances are the JAX version's expansion
‖q‖² + ‖r‖² − 2 q·r, clamped at 0 (not ``torch.cdist``, whose rounding
differs near the anchor radius).  The references are compacted to the
valid ones first and the indices mapped back.

``knn`` sends a CUDA call with k = 1 and no ``exclude_self`` (the anchor,
the normal init, the chamfer) to ``csrc/knn1.cu``, which keeps each
query's running minimum in registers (``knn.launches`` counts each
launch).  Every other call, and every CPU call, takes the plain twin
``knn_ref``: blocks of queries sized so that one (block, refs) float32
distance block stays near BLOCK_BYTES (131,072 queries against ~960k mesh
faces would take 500 GB at once).  While a profiler records, each call
adds its (query, valid ref) pairs to the counter ``knn.pairs``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import tracing
from . import cuda_build

BLOCK_BYTES = 1 << 30


def _compact(refs: torch.Tensor, ref_valid: Optional[torch.Tensor]):
    """The valid refs and their indices (None where every ref is valid)."""
    if ref_valid is None:
        return refs, None
    ids = torch.nonzero(ref_valid).reshape(-1)
    return refs[ids], ids


def _blocked(queries, r, ids, k: int, exclude_self: bool, chunk: Optional[int]):
    Q, dev = queries.shape[0], queries.device
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


def knn_ref(queries: torch.Tensor, refs: torch.Tensor, k: int,
            ref_valid: Optional[torch.Tensor] = None, exclude_self: bool = False,
            chunk: Optional[int] = None):
    """Plain PyTorch twin of ``knn``, on any device: the blocked search."""
    r, ids = _compact(refs, ref_valid)
    return _blocked(queries, r, ids, k, exclude_self, chunk)


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int,
        ref_valid: Optional[torch.Tensor] = None, exclude_self: bool = False,
        chunk: Optional[int] = None):
    """Squared distances (Q,k) and indices (Q,k) int64 of the k nearest refs
    (R,3) to each query (Q,3), nearest first.

    Invalid refs (``ref_valid`` False) count as +inf, and so does the ref
    of a query's own index with ``exclude_self`` (self-kNN where queries is
    refs); a missing neighbour is (+inf, 0).  With k = 1 a tie goes to the
    lowest index, as in JAX, and a query whose distances meet a NaN reads
    (NaN, 0); for k > 1 ``torch.topk`` orders ties.  ``chunk`` fixes the
    twin's queries per block (the kernel takes none)."""
    r, ids = _compact(refs, ref_valid)
    tracing.count("knn.pairs", queries.shape[0] * r.shape[0])
    if k == 1 and not exclude_self and queries.device.type == "cuda":
        return _knn1(queries, r, ids)
    return _blocked(queries, r, ids, k, exclude_self, chunk)


def _knn1(queries: torch.Tensor, r: torch.Tensor, ids: Optional[torch.Tensor]):
    """k = 1 through ``csrc/knn1.cu`` on the compacted refs ``r``."""
    if queries.dtype != torch.float32 or r.dtype != torch.float32:
        raise TypeError(f"knn: the kernel takes float32 points, got {queries.dtype}, {r.dtype}")
    if queries.dim() != 2 or queries.shape[1] != 3 or r.dim() != 2 or r.shape[1] != 3:
        raise ValueError(f"knn: points must be (N,3), got {tuple(queries.shape)}, "
                         f"{tuple(r.shape)}")
    Q, R, dev = queries.shape[0], r.shape[0], queries.device
    if R == 0 or Q == 0:
        return (torch.full((Q, 1), float("inf"), device=dev),
                torch.zeros((Q, 1), dtype=torch.long, device=dev))
    q = queries.contiguous()
    qq = (q * q).sum(-1)                     # the twin's ‖q‖² and ‖r‖², bit for bit
    lib = cuda_build.library("knn1")
    tile = lib.knn1_tile()
    n_tiles = -(-R // tile)
    r4 = torch.empty((n_tiles * tile, 4), device=dev)
    r4[:R, :3] = r * -2.0
    r4[:R, 3] = (r * r).sum(-1)
    r4[R:] = r4[R - 1]                       # whole tiles: copies of the last ref never win
    out_d = torch.empty((Q, 1), device=dev)
    out_i = torch.empty((Q, 1), dtype=torch.long, device=dev)
    fn = lib.knn1_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), qq.data_ptr(), r4.data_ptr(), Q, n_tiles,
                 None if ids is None else ids.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                 stream)
    cuda_build.check(err, "knn")
    knn.launches += 1
    return out_d, out_i


knn.launches = 0


def mean_knn_dist2(points: torch.Tensor, valid: Optional[torch.Tensor] = None, k: int = 3,
                   chunk: Optional[int] = None) -> torch.Tensor:
    """Mean squared distance to the k nearest other points, per point (N,).

    With ``valid``, invalid points are ignored as neighbours and a missing
    neighbour counts as 0, as in the JAX version."""
    d2, _ = knn(points, points, k, ref_valid=valid, exclude_self=True, chunk=chunk)
    if valid is not None:
        d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return d2.mean(-1)
