"""Point-set evaluation metrics: Chamfer distance and EMD.

Counterpart of dgmesh_tpu/ops/chamfer.py (the reference's chamferdist,
mesh_evaluation.py:8,67-70; StructuralLosses' nn_distance/ApproxMatch,
metrics/evaluation_metrics.py:42-62).  Chamfer is exact, through
``ops/knn.py::knn`` with k = 1 (the JAX version's distance expansion, a tie
to the lowest index).  EMD is entropic-regularised Sinkhorn in the log
domain, as in JAX, with JAX's arithmetic: the euclidean cost, eps a
fraction of its mean, 600 iterations.  Neither is a Pallas kernel in JAX:
both are plain PyTorch here, without autograd.  At the mesh evaluation's
8192 samples the cost matrix is 268 MB; the Sinkhorn loop keeps it, one
buffer of its size and ``torch.logsumexp``'s one temporary alive.
"""

from __future__ import annotations

import math

import torch

from .knn import knn


@torch.no_grad()
def chamfer(a: torch.Tensor, b: torch.Tensor, a_valid=None, b_valid=None,
            squared: bool = True):
    """Bidirectional Chamfer distance between (N,3) and (M,3) point sets.

    Returns (cd, d_a2b (N,), d_b2a (M,)).  cd = mean_a min_b d + mean_b
    min_a d, squared euclidean by default (emd_cd's convention); with
    ``a_valid``/``b_valid`` the invalid points are neither neighbours nor
    counted in their side's mean."""
    d_ab = knn(a, b, 1, ref_valid=b_valid)[0][:, 0]
    d_ba = knn(b, a, 1, ref_valid=a_valid)[0][:, 0]
    if not squared:
        d_ab = torch.sqrt(d_ab.clamp_min(0))
        d_ba = torch.sqrt(d_ba.clamp_min(0))

    def mean(d, valid):
        if valid is None:
            return d.mean()
        return torch.where(valid, d, 0.0).sum() / valid.sum().clamp_min(1)

    return mean(d_ab, a_valid) + mean(d_ba, b_valid), d_ab, d_ba


def _cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The euclidean cost sqrt(max(‖a‖² + ‖b‖² − 2 a·b, 1e-12)), (N,M)."""
    c = (a * a).sum(-1, keepdim=True) + (b * b).sum(-1)[None, :]
    c.sub_(a @ b.T, alpha=2.0)
    return c.clamp_min_(1e-12).sqrt_()


@torch.no_grad()
def emd_sinkhorn(a: torch.Tensor, b: torch.Tensor, epsilon: float = 0.005,
                 iters: int = 600) -> torch.Tensor:
    """Entropic-regularised earth mover's distance between equal-size (N,3)
    sets: Σ P·C with P from Sinkhorn on the euclidean cost (uniform
    marginals), the mean matched distance (the reference's ApproxMatch
    match_cost / N).  Within 0.5% of the exact assignment at these
    defaults (tests/test_geometry_ops.py::test_emd_sinkhorn_vs_exact
    calibrates the JAX version)."""
    n = a.shape[0]
    log_k = _cost(a, b)
    eps = epsilon * log_k.mean()            # scale-invariant regularisation
    log_k.div_(-eps)                        # −C/eps, in place
    logu = a.new_zeros(n)
    logv = a.new_zeros(n)
    log_marg = -math.log(n)
    buf = torch.empty_like(log_k)
    for _ in range(iters):
        logu = log_marg - torch.logsumexp(torch.add(log_k, logv[None, :], out=buf), dim=1)
        logv = log_marg - torch.logsumexp(torch.add(log_k, logu[:, None], out=buf), dim=0)
    p = torch.add(logu[:, None], log_k, out=buf).add_(logv[None, :]).exp_()
    del log_k
    return p.mul_(_cost(a, b)).sum()
