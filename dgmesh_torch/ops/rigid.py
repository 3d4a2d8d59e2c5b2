"""SE(3)/SO(3) exponential maps for the optional 6-DoF deformation head.

Counterpart of dgmesh_tpu/ops/rigid.py (reference utils/rigid_utils.py:
skew :4, exp_so3 :40, exp_se3 :60-83), with the same arithmetic: Rodrigues
for the rotation, V·v for the translation, and the homogeneous divide of
the transformed point.  Used by ``DeformNetwork(is_6dof=True)`` (off in
every shipped config).
"""

from __future__ import annotations

import torch


def skew(w: torch.Tensor) -> torch.Tensor:
    """(...,3) → (...,3,3) cross-product matrix."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def exp_so3(w: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues: exp([w]θ), w a unit axis (...,3), theta (...,1)."""
    W = skew(w)
    t = theta[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + torch.sin(t) * W + (1.0 - torch.cos(t)) * (W @ W)


def exp_se3(S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """SE(3) exp of the screw axis S = (w, v) (...,6) times theta (...,1) →
    (...,4,4)."""
    w, v = S[..., :3], S[..., 3:]
    W = skew(w)
    R = exp_so3(w, theta)
    t = theta[..., None]
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    V = eye * t + (1.0 - torch.cos(t)) * W + (t - torch.sin(t)) * (W @ W)
    p = (V @ v[..., None])[..., 0]
    top = torch.cat([R, p[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=S.dtype,
                          device=S.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], -2)


def se3_transform_points(xyz: torch.Tensor, S: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Apply per-point screw motions to points (the reference DeformNetwork's
    is_6dof branch, utils/time_utils.py:117-124)."""
    T = exp_se3(S, theta)
    hom = torch.cat([xyz, torch.ones_like(xyz[..., :1])], -1)
    out = (T @ hom[..., None])[..., 0]
    return out[..., :3] / torch.clamp_min(out[..., 3:], 1e-9)
