"""Canonical Gaussian point-set state in the padded layout.

Counterpart of dgmesh_tpu/models/gaussians.py (reference
scene/gaussian_model_dpsr_dynamic_anchor.py): fixed-capacity tensors plus an
``alive`` mask, the same leaves as the JAX ``GaussianParams`` /
``GaussianStats``, so a JAX state carries across leaf by leaf (convert.py).

  xyz (M,3) · f_dc (M,1,3) · f_rest (M,15,3) · scaling (M,3) log-scale ·
  rotation (M,4) wxyz · opacity (M,1) logit · normal (M,3) · density_thres ()
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class GaussianParams(NamedTuple):
    """Learnable leaves."""
    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    normal: torch.Tensor
    density_thres: torch.Tensor


class GaussianStats(NamedTuple):
    """Non-learnable companions."""
    alive: torch.Tensor            # (M,) bool
    max_radii2d: torch.Tensor      # (M,)
    xyz_grad_accum: torch.Tensor   # (M,)
    denom: torch.Tensor            # (M,)
    gaussian_center: torch.Tensor  # (3,)
    gaussian_scale: torch.Tensor   # ()


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


# --- activations (reference: gaussian_model.py:73-81) -----------------------

def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    n = torch.linalg.norm(p.rotation, dim=-1, keepdim=True)
    return p.rotation / (n + 1e-12)


def get_features(p: GaussianParams) -> torch.Tensor:
    """(M, 16, 3) concatenated SH coefficients."""
    return torch.cat([p.f_dc, p.f_rest], dim=1)


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    sh_degree: int = 3, init_density_threshold: float = 0.0,
                    device: DeviceLike = None) -> Tuple[GaussianParams, GaussianStats]:
    """Initialise from a point cloud (reference create_from_pcd :155-184).

    Scale = log(sqrt(mean 3-NN squared distance)); opacity = logit(0.1);
    identity rotation; zero normals.
    """
    from ..ops.knn import mean_knn_dist2
    from ..ops.sh import rgb_to_sh

    dev = resolve_device(device)
    n = points.shape[0]
    assert n <= capacity, f"{n} points exceed capacity {capacity}"
    M = capacity
    f32 = dict(dtype=torch.float32, device=dev)

    xyz = torch.zeros((M, 3), **f32)
    xyz[:n] = torch.as_tensor(points, **f32)
    f_dc = torch.zeros((M, 1, 3), **f32)
    f_dc[:n, 0] = rgb_to_sh(torch.as_tensor(colors, **f32))
    f_rest = torch.zeros((M, 15, 3), **f32)

    alive = torch.zeros(M, dtype=torch.bool, device=dev)
    alive[:n] = True
    # only live rows are queried: dead rows' scales stay 0 (never read)
    d2 = mean_knn_dist2(xyz[:n], alive[:n], k=3).clamp_min(1e-7)
    scaling = torch.zeros((M, 3), **f32)
    scaling[:n] = torch.log(torch.sqrt(d2))[:, None]

    rotation = torch.zeros((M, 4), **f32)
    rotation[:, 0] = 1.0
    opacity = torch.full((M, 1), float(inverse_sigmoid(torch.tensor(0.1))), **f32)
    params = GaussianParams(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest, scaling=scaling, rotation=rotation,
        opacity=opacity, normal=torch.zeros((M, 3), **f32),
        density_thres=torch.tensor(float(init_density_threshold), **f32))
    stats = GaussianStats(
        alive=alive, max_radii2d=torch.zeros(M, **f32),
        xyz_grad_accum=torch.zeros(M, **f32), denom=torch.zeros(M, **f32),
        gaussian_center=torch.zeros(3, **f32),
        gaussian_scale=torch.tensor(1.0, **f32))
    return params, stats


def update_scale_center(params: GaussianParams, stats: GaussianStats,
                        gaussian_ratio: float,
                        fixed_center: Optional[list] = None) -> GaussianStats:
    """Fit the DPSR normalisation frame around the live point set
    (reference update_scale_center :94-120)."""
    big = 1e9
    alive = stats.alive[:, None]
    mins = torch.where(alive, params.xyz, big).amin(0)
    maxs = torch.where(alive, params.xyz, -big).amax(0)
    if fixed_center is None:
        center = (mins + maxs) / 2.0
        half = torch.stack([maxs - center, center - mins]).abs().max()
    else:
        center = torch.as_tensor(fixed_center, dtype=torch.float32,
                                 device=params.xyz.device)
        half = torch.maximum((maxs - center).abs(), (center - mins).abs()).max()
    return stats._replace(gaussian_center=center, gaussian_scale=half * gaussian_ratio)
