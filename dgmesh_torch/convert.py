"""Carry a JAX state across: numpy leaves → the port's tensors and modules.

Inputs are the JAX package's structures with every leaf already converted to
numpy (for example ``jax.tree.map(np.asarray, state)``), or the nested maps
that train/checkpoint.py decodes from a flax ``state_N.msgpack``: the
``GaussianParams`` / ``GaussianStats`` leaves and their Adam moments, for
each of the five nets flax's parameter tree, a nested dict (optionally under
``"params"``), and optax's ScaleByAdamState (``count``, ``mu``, ``nu``).  Flax
names the layers ``Dense_0``, ``Dense_1``, … in creation order and the trunk
``MLPTrunk_0`` with ``w{i}``/``b{i}``; its ``Dense`` kernels are (in, out)
where ``nn.Linear`` keeps (out, in).  Nothing here imports flax or JAX.
"""

from __future__ import annotations

import itertools
from typing import Any, List, Mapping

import numpy as np
import torch

from .config import Config
from .device import DeviceLike, resolve_device
from .models import mlp
from .models.gaussians import GaussianParams, GaussianStats
from .train.state import NetAdam, NetParams, TrainState, build_nets


def _field(obj: Any, name: str):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def gaussians_from_numpy(gp, gs, device: DeviceLike = None):
    """JAX ``GaussianParams``/``GaussianStats`` leaves → the port's tuples."""
    dev = resolve_device(device)

    def t(x):
        x = np.asarray(x)
        return torch.tensor(x, dtype=torch.bool if x.dtype == bool else torch.float32,
                            device=dev)

    return (GaussianParams(*[t(_field(gp, f)) for f in GaussianParams._fields]),
            GaussianStats(*[t(_field(gs, f)) for f in GaussianStats._fields]))


def _flax_layers(net: mlp._TimeConditioned, tree: Mapping):
    """(nn.Linear, its flax subtree with ``kernel``/``bias``) for every layer
    of ``net``, by flax's names: the timenet Denses come first (Blender
    nets only: without a timenet, as on real captures, the heads start at
    ``Dense_0``), then the trunk, then the heads in the order ``heads``
    lists them (the 6-DoF head's w and v Denses where d_xyz's would be)."""
    tree = tree.get("params", tree)
    dense = (f"Dense_{i}" for i in itertools.count())
    out = []
    if net.is_blender:
        out += [(net.timenet0, tree[next(dense)]), (net.timenet1, tree[next(dense)])]
    trunk = tree["MLPTrunk_0"]
    out += [(layer, {"kernel": trunk[f"w{i}"], "bias": trunk[f"b{i}"]})
            for i, layer in enumerate(net.trunk.layers)]
    if isinstance(net, mlp.DeformNetwork):
        first = [net.head_w, net.head_v] if net.is_6dof else [net.head_xyz]
        heads = first + [net.head_rot, net.head_scale]
        if net.with_normal:
            heads.append(net.head_normal)
    elif isinstance(net, mlp.DeformNetworkNormalSep):
        heads = [net.head_normal]
    else:
        heads = [net.head_rgb]
    return out + [(h, tree[next(dense)]) for h in heads]


def flax_leaves(net: mlp._TimeConditioned, tree: Mapping) -> List[np.ndarray]:
    """A flax-shaped tree (parameters, their gradients or Adam moments) as
    arrays in ``net.parameters()`` order and layout: a Dense kernel (in, out)
    becomes the (out, in) ``weight``."""
    by_param = {}
    for layer, t in _flax_layers(net, tree):
        by_param[id(layer.weight)] = np.asarray(t["kernel"]).T
        by_param[id(layer.bias)] = np.asarray(t["bias"])
    return [by_param[id(p)] for p in net.parameters()]


def load_flax_params(net: mlp._TimeConditioned, tree: Mapping) -> None:
    """Copy one flax parameter tree into ``net`` (in place)."""
    with torch.no_grad():
        for p, x in zip(net.parameters(), flax_leaves(net, tree)):
            p.copy_(torch.tensor(np.ascontiguousarray(x)))


def nets_from_flax(cfg: Config, nets, device: DeviceLike = None) -> NetParams:
    """The five flax trees (``NetParams`` fields) → the port's modules."""
    dev = resolve_device(device)
    out = build_nets(cfg, device="cpu")
    for name, net in zip(NetParams._fields, out):
        load_flax_params(net, _field(nets, name))
    return NetParams(*[n.to(dev) for n in out])


def net_adam_from_optax(net: mlp._TimeConditioned, opt, device: DeviceLike = None) -> NetAdam:
    """optax's ScaleByAdamState (``count``, ``mu``, ``nu``; numpy leaves) of
    one net → the port's NetAdam, moments in ``net.parameters()`` order."""
    dev = resolve_device(device)

    def tensors(tree):
        return tuple(torch.tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)
                     for x in flax_leaves(net, tree))

    return NetAdam(count=torch.tensor(int(np.asarray(_field(opt, "count"))),
                                      dtype=torch.int32, device=dev),
                   mu=tensors(_field(opt, "mu")), nu=tensors(_field(opt, "nu")))


def state_from_jax(cfg: Config, state, device: DeviceLike = None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``) → the port's state: parameters, statistics, the Gaussian Adam
    moments and count, each net's optax Adam state, and the step."""
    dev = resolve_device(device)
    gp, gs = gaussians_from_numpy(_field(state, "gp"), _field(state, "gs"), dev)
    g_mu, _ = gaussians_from_numpy(_field(state, "g_mu"), _field(state, "gs"), dev)
    g_nu, _ = gaussians_from_numpy(_field(state, "g_nu"), _field(state, "gs"), dev)
    nets = nets_from_flax(cfg, _field(state, "nets"), dev)
    opts = _field(state, "net_opt")
    net_opt = NetParams(*[net_adam_from_optax(net, _field(opts, name), dev)
                          for name, net in zip(NetParams._fields, nets)])

    def i32(x):
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32, device=dev)

    return TrainState(gp=gp, gs=gs, nets=nets, g_mu=g_mu, g_nu=g_nu,
                      g_count=i32(_field(state, "g_count")), net_opt=net_opt,
                      step=i32(_field(state, "step")))
