"""Model state: the padded Gaussians and the five networks.

Counterpart of the state half of dgmesh_tpu/train/state.py (``build_nets``,
``init_state``).  Optimizer state comes with training.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..models import mlp
from ..models.gaussians import (GaussianParams, GaussianStats, create_from_pcd,
                                update_scale_center)


class NetParams(NamedTuple):
    deform: torch.nn.Module
    deform_normal: torch.nn.Module
    deform_back: torch.nn.Module
    deform_back_normal: torch.nn.Module
    appearance: torch.nn.Module


class TrainState(NamedTuple):
    gp: GaussianParams
    gs: GaussianStats
    nets: NetParams


def build_nets(cfg: Config, gen: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> NetParams:
    """The five networks, initialised from ``gen`` (flax's initialisers:
    lecun-normal kernels, zero biases, zero offset heads)."""
    dev = resolve_device(device)
    is_b = cfg.model.is_blender
    kw = dict(is_blender=is_b, gen=gen, device=dev)
    return NetParams(
        deform=mlp.DeformNetwork(with_normal=True, is_6dof=cfg.model.is_6dof, **kw),
        deform_normal=mlp.DeformNetworkNormalSep(**kw),
        deform_back=mlp.DeformNetwork(with_normal=True, is_6dof=cfg.model.is_6dof, **kw),
        deform_back_normal=mlp.DeformNetworkNormalSep(**kw),
        appearance=mlp.AppearanceNetwork(**kw),
    )


def init_state(cfg: Config, points: np.ndarray, colors: np.ndarray,
               seed: int = 0, device: DeviceLike = None) -> TrainState:
    dev = resolve_device(device)
    gp, gs = create_from_pcd(points, colors, capacity=cfg.tpu.max_gaussians,
                             sh_degree=cfg.model.sh_degree,
                             init_density_threshold=cfg.optimization.init_density_threshold,
                             device=dev)
    fixed = (cfg.model.gaussian_center
             if cfg.model.data_type in ("iPhone", "NeuralActor") else None)
    gs = update_scale_center(gp, gs, cfg.model.gaussian_ratio, fixed_center=fixed)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nets = build_nets(cfg, gen=gen, device="cpu")
    nets = NetParams(*[n.to(dev) for n in nets])
    return TrainState(gp=gp, gs=gs, nets=nets)


def state_to(state: TrainState, device: DeviceLike) -> TrainState:
    """A copy of the state on another device (modules are copied, not moved)."""
    dev = resolve_device(device)
    return TrainState(gp=GaussianParams(*[x.to(dev) for x in state.gp]),
                      gs=GaussianStats(*[x.to(dev) for x in state.gs]),
                      nets=NetParams(*[copy.deepcopy(n).to(dev) for n in state.nets]))
