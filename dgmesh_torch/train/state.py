"""Training state: the padded Gaussians, the five networks and their optimizers.

Counterpart of dgmesh_tpu/train/state.py: a masked Adam for the padded
Gaussian arrays (moments shaped like the parameters, zero in dead slots) and
one Adam per network equal to optax's ``scale_by_adam(eps=1e-15)`` followed
by ``-lr·u``.  The learning-rate schedules are the reference's, including its
swapped rotation and normal schedules (update_learning_rate :222-236 gives
the rotation group the rotation_lr·100 → ·10 schedule and the normal group
the rotation_lr → ·0.1 one).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..models import mlp
from ..models.gaussians import (GaussianParams, GaussianStats, create_from_pcd,
                                update_scale_center)
from ..schedules import expon_lr

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15   # reference: Adam(eps=1e-15)
# density_thres is projected into [-1, 1] after each step, as in JAX
# (dgmesh_tpu/train/state.py DENSITY_THRES_BOUND)
DENSITY_THRES_BOUND = 1.0


class NetParams(NamedTuple):
    deform: torch.nn.Module
    deform_normal: torch.nn.Module
    deform_back: torch.nn.Module
    deform_back_normal: torch.nn.Module
    appearance: torch.nn.Module


class NetAdam(NamedTuple):
    """One net's Adam state, as optax's ScaleByAdamState: the step count and
    the moments, one per tensor of ``net.parameters()`` in that order."""
    count: torch.Tensor              # () int32
    mu: Tuple[torch.Tensor, ...]
    nu: Tuple[torch.Tensor, ...]


class TrainState(NamedTuple):
    gp: GaussianParams
    gs: GaussianStats
    nets: NetParams
    g_mu: GaussianParams       # Adam first moments, shaped like gp
    g_nu: GaussianParams       # Adam second moments
    g_count: torch.Tensor      # () int32: the Gaussian groups' shared Adam count
    net_opt: NetParams         # NetAdam per net
    step: torch.Tensor         # () int32: the global iteration


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
        deform_back=mlp.DeformNetwork(with_normal=True, is_6dof=cfg.model.is_6dof,
                                      field="deform_back", **kw),
        deform_back_normal=mlp.DeformNetworkNormalSep(field="deform_back_normal", **kw),
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
    zeros = GaussianParams(*[torch.zeros_like(x) for x in gp])
    return TrainState(gp=gp, gs=gs, nets=nets, g_mu=zeros,
                      g_nu=GaussianParams(*[torch.zeros_like(x) for x in gp]),
                      g_count=torch.zeros((), dtype=torch.int32, device=dev),
                      net_opt=NetParams(*[net_adam_init(n) for n in nets]),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def net_adam_init(net: torch.nn.Module) -> NetAdam:
    ps = list(net.parameters())
    return NetAdam(count=torch.zeros((), dtype=torch.int32, device=ps[0].device),
                   mu=tuple(torch.zeros_like(p) for p in ps),
                   nu=tuple(torch.zeros_like(p) for p in ps))


def state_to(state: TrainState, device: DeviceLike) -> TrainState:
    """A copy of the state on another device (modules are copied, not moved)."""
    dev = resolve_device(device)

    def mv(tup):
        return type(tup)(*[x.to(dev) for x in tup])

    return TrainState(
        gp=mv(state.gp), gs=mv(state.gs),
        nets=NetParams(*[copy.deepcopy(n).to(dev) for n in state.nets]),
        g_mu=mv(state.g_mu), g_nu=mv(state.g_nu), g_count=state.g_count.to(dev),
        net_opt=NetParams(*[NetAdam(o.count.to(dev), tuple(x.to(dev) for x in o.mu),
                                    tuple(x.to(dev) for x in o.nu))
                            for o in state.net_opt]),
        step=state.step.to(dev))


# --- learning-rate schedules ------------------------------------------------

def gaussian_group_lrs(step, cfg: Config) -> GaussianParams:
    """Per-group learning rate at ``step`` (reference training_setup +
    update_learning_rate), with the reference's swapped rotation/normal
    schedules."""
    o = cfg.optimization
    s = 5.0  # spatial_lr_scale (gaussian model, :192)
    step = step if isinstance(step, torch.Tensor) else torch.tensor(step)
    const = lambda v: torch.tensor(v, dtype=torch.float32, device=step.device)  # noqa: E731
    return GaussianParams(
        xyz=expon_lr(step, o.position_lr_init * s, o.position_lr_final * s,
                     max_steps=o.position_lr_max_steps),
        f_dc=const(o.feature_lr),
        f_rest=const(o.feature_lr / 20.0),
        scaling=const(o.scaling_lr * s),
        rotation=expon_lr(step, o.rotation_lr * 100.0, o.rotation_lr * 10.0,
                          max_steps=o.position_lr_max_steps),
        opacity=const(o.opacity_lr),
        normal=expon_lr(step, o.rotation_lr, o.rotation_lr * 0.1,
                        max_steps=o.position_lr_max_steps),
        density_thres=expon_lr(step, 0.01, 1e-4, max_steps=o.position_lr_max_steps),
    )


def net_lrs(step, cfg: Config) -> NetParams:
    o = cfg.optimization
    return NetParams(
        deform=expon_lr(step, o.position_lr_init * 5, o.position_lr_final,
                        max_steps=o.deform_lr_max_steps),
        deform_normal=expon_lr(step, o.position_lr_init * 10, o.position_lr_final * 10,
                               max_steps=o.deform_lr_max_steps),
        deform_back=expon_lr(step, o.position_lr_init * 5, o.position_lr_final,
                             max_steps=o.deform_lr_max_steps),
        deform_back_normal=expon_lr(step, o.position_lr_init * 10, o.position_lr_final * 10,
                                    max_steps=o.deform_lr_max_steps),
        appearance=expon_lr(step, o.apperance_lr_init, o.apperance_lr_final,
                            lr_delay_mult=o.apperance_lr_delay_mult,
                            max_steps=o.apperance_lr_max_steps),
    )


# --- the optimizers -----------------------------------------------------------

@torch.no_grad()
def gaussian_adam_update(gp: GaussianParams, grads: GaussianParams, mu: GaussianParams,
                         nu: GaussianParams, count: torch.Tensor, lrs: GaussianParams,
                         alive: torch.Tensor):
    """One Adam step over every Gaussian group, masked to live slots: dead
    slots keep their parameters and zero moments.  ``density_thres`` (a
    scalar, always live) is clamped to ±DENSITY_THRES_BOUND after the step.
    Returns new (gp, mu, nu, count); the inputs are not modified."""
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - ADAM_B1 ** c
    bc2 = 1.0 - ADAM_B2 ** c
    new_p, new_m, new_v = [], [], []
    for name in GaussianParams._fields:
        p, g = getattr(gp, name), getattr(grads, name)
        m, v, lr = getattr(mu, name), getattr(nu, name), getattr(lrs, name)
        m2 = ADAM_B1 * m + (1 - ADAM_B1) * g
        v2 = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        step = lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
        if name == "density_thres":
            p2 = torch.clamp(p - step, -DENSITY_THRES_BOUND, DENSITY_THRES_BOUND)
        else:
            mask = alive.reshape((-1,) + (1,) * (p.dim() - 1))
            m2 = torch.where(mask, m2, 0.0)
            v2 = torch.where(mask, v2, 0.0)
            p2 = torch.where(mask, p - step, p)
        new_p.append(p2)
        new_m.append(m2)
        new_v.append(v2)
    return GaussianParams(*new_p), GaussianParams(*new_m), GaussianParams(*new_v), count


@torch.no_grad()
def net_adam_update(net: torch.nn.Module, grads: Sequence[torch.Tensor], opt: NetAdam,
                    lr: torch.Tensor):
    """optax ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-15)`` then ``p + (-lr·u)``.
    Returns (a new module with the stepped parameters, the new NetAdam); the
    inputs are not modified."""
    count = opt.count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - ADAM_B1 ** c
    bc2 = 1.0 - ADAM_B2 ** c
    new = copy.deepcopy(net)
    mus, nus = [], []
    for p, g, m, v in zip(new.parameters(), grads, opt.mu, opt.nu):
        m2 = (1 - ADAM_B1) * g + ADAM_B1 * m
        v2 = (1 - ADAM_B2) * (g * g) + ADAM_B2 * v
        u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
        p.add_(-lr * u)
        mus.append(m2)
        nus.append(v2)
    return new, NetAdam(count=count, mu=tuple(mus), nu=tuple(nus))
