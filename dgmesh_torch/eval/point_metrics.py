"""Point-cloud distribution metrics: MMD / COV / 1-NNA / JSD + emd_cd.

Counterpart of dgmesh_tpu/eval/point_metrics.py (reference
metrics/evaluation_metrics.py — emd_cd :42-62, the pairwise suite
:72-299).  The distances come from ``ops/chamfer.py`` on
``device`` (cuda unless the caller asks for the CPU); the reductions over
the distance matrices are the JAX version's numpy, copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.chamfer import chamfer, emd_sinkhorn


def _t(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def emd_cd(sample_pcs, ref_pcs, reduced: bool = True, device: DeviceLike = None):
    """Matched-pair CD + EMD (reference emd_cd :42-62).

    sample_pcs, ref_pcs: (B, N, 3) arrays.  CD = mean_a2b + mean_b2a of
    squared distances; EMD = approx transport cost per point."""
    device = resolve_device(device)
    cds, emds = [], []
    for s, r in zip(sample_pcs, ref_pcs):
        s, r = _t(s, device), _t(r, device)
        cds.append(float(chamfer(s, r)[0]))
        emds.append(float(emd_sinkhorn(s, r)))
    if reduced:
        return dict(CD=float(np.mean(cds)), EMD=float(np.mean(emds)))
    return dict(CD=np.asarray(cds), EMD=np.asarray(emds))


def pairwise_cd(sample_pcs, ref_pcs, device: DeviceLike = None):
    """(S, R) matrix of chamfer distances (reference _pairwise_EMD_CD_)."""
    device = resolve_device(device)
    S, R = len(sample_pcs), len(ref_pcs)
    out = np.zeros((S, R), np.float64)
    for i in range(S):
        for j in range(R):
            out[i, j] = float(chamfer(_t(sample_pcs[i], device), _t(ref_pcs[j], device))[0])
    return out


def mmd_cov(all_dist: np.ndarray):
    """lgan_mmd_cov (reference :100-117): rows = samples, cols = refs."""
    min_val_fromsmp = all_dist.min(axis=1)
    min_idx = all_dist.argmin(axis=1)
    min_val = all_dist.min(axis=0)
    mmd = min_val.mean()
    mmd_smp = min_val_fromsmp.mean()
    cov = float(len(np.unique(min_idx))) / all_dist.shape[1]
    return dict(MMD=float(mmd), COV=float(cov), MMD_smp=float(mmd_smp))


def one_nna(dist_ss: np.ndarray, dist_sr: np.ndarray, dist_rr: np.ndarray):
    """1-nearest-neighbour accuracy two-sample test (reference knn :120-160)."""
    S, R = dist_sr.shape
    big = np.block([[dist_ss, dist_sr], [dist_sr.T, dist_rr]])
    np.fill_diagonal(big, np.inf)
    labels = np.concatenate([np.ones(S), np.zeros(R)])
    nn = big.argmin(axis=1)
    pred = labels[nn]
    acc = (pred == labels).mean()
    return dict(acc=float(acc),
                acc_t=float((pred[S:] == labels[S:]).mean()),
                acc_f=float((pred[:S] == labels[:S]).mean()))


def _cloud_to_voxel_hist(pc: np.ndarray, res: int = 28):
    """Occupancy histogram in the unit cube (reference entropy_of_occupancy_grid)."""
    pts = np.clip((pc + 1.0) / 2.0, 0, 1 - 1e-6)
    idx = (pts * res).astype(np.int32)
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    hist = np.bincount(flat, minlength=res ** 3).astype(np.float64)
    return hist


def jsd_between_point_cloud_sets(sample_pcs, ref_pcs, res: int = 28):
    """Jensen-Shannon divergence between voxel-occupancy distributions
    (reference jsd_between_point_cloud_sets :163-200)."""
    def agg(pcs):
        h = np.zeros(res ** 3, np.float64)
        for pc in pcs:
            h += _cloud_to_voxel_hist(np.asarray(pc), res)
        p = h / max(h.sum(), 1e-12)
        return p

    p, q = agg(sample_pcs), agg(ref_pcs)
    m = 0.5 * (p + q)

    def kl(a, b):
        mask = a > 0
        return float((a[mask] * np.log2(a[mask] / np.maximum(b[mask], 1e-20))).sum())

    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def compute_all_metrics(sample_pcs, ref_pcs, device: DeviceLike = None):
    """Full suite (reference compute_all_metrics :203-240)."""
    d_sr = pairwise_cd(sample_pcs, ref_pcs, device)
    d_ss = pairwise_cd(sample_pcs, sample_pcs, device)
    d_rr = pairwise_cd(ref_pcs, ref_pcs, device)
    res = {f"CD_{k}": v for k, v in mmd_cov(d_sr).items()}
    res.update({f"1-NNA_CD_{k}": v for k, v in one_nna(d_ss, d_sr, d_rr).items()})
    res["JSD"] = jsd_between_point_cloud_sets(sample_pcs, ref_pcs)
    return res
