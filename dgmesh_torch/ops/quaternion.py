"""Quaternion and 3D-covariance helpers, (w, x, y, z) layout.

Counterpart of dgmesh_tpu/ops/quaternion.py (reference utils/general_utils.py
build_rotation / build_scaling_rotation).
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation matrix (..., 3, 3)."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1)
    r1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1)
    r2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([r0, r1, r2], dim=-2)


def build_covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Σ = R S Sᵀ Rᵀ per Gaussian (reference forward.cu computeCov3D :118-152)."""
    R = quat_to_rotmat(quats)
    M = R * scales[..., None, :]           # R @ diag(s)
    return M @ M.transpose(-1, -2)
