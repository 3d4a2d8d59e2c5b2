"""Carry a JAX state across: numpy leaves → the port's tensors and modules.

Inputs are the JAX package's structures with every leaf already converted to
numpy (for example ``jax.tree.map(np.asarray, state.gp)``): the
``GaussianParams`` / ``GaussianStats`` leaves, and for each of the five nets
flax's parameter tree, a nested dict (optionally under ``"params"``).  Flax
names the layers ``Dense_0``, ``Dense_1``, … in creation order and the trunk
``MLPTrunk_0`` with ``w{i}``/``b{i}``; its ``Dense`` kernels are (in, out)
where ``nn.Linear`` keeps (out, in).  Nothing here imports flax or JAX.
"""

from __future__ import annotations

import itertools
from typing import Any, Mapping

import numpy as np
import torch

from .config import Config
from .device import DeviceLike, resolve_device
from .models import mlp
from .models.gaussians import GaussianParams, GaussianStats
from .train.state import NetParams, TrainState, build_nets


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


def _load_dense(layer: torch.nn.Linear, tree: Mapping) -> None:
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(tree["kernel"]).T))
        layer.bias.copy_(torch.tensor(np.asarray(tree["bias"])))


def _load_trunk(trunk: mlp.MLPTrunk, tree: Mapping) -> None:
    with torch.no_grad():
        for i, layer in enumerate(trunk.layers):
            layer.weight.copy_(torch.tensor(np.asarray(tree[f"w{i}"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(tree[f"b{i}"])))


def load_flax_params(net: mlp._TimeConditioned, tree: Mapping) -> None:
    """Copy one flax parameter tree into ``net`` (in place), by flax's names:
    the timenet Denses come first, then the heads in the order
    ``heads`` lists them."""
    tree = tree.get("params", tree)
    dense = (f"Dense_{i}" for i in itertools.count())
    if net.is_blender:
        _load_dense(net.timenet0, tree[next(dense)])
        _load_dense(net.timenet1, tree[next(dense)])
    _load_trunk(net.trunk, tree["MLPTrunk_0"])
    if isinstance(net, mlp.DeformNetwork):
        heads = [net.head_xyz, net.head_rot, net.head_scale]
        if net.with_normal:
            heads.append(net.head_normal)
    elif isinstance(net, mlp.DeformNetworkNormalSep):
        heads = [net.head_normal]
    else:
        heads = [net.head_rgb]
    for h in heads:
        _load_dense(h, tree[next(dense)])


def nets_from_flax(cfg: Config, nets, device: DeviceLike = None) -> NetParams:
    """The five flax trees (``NetParams`` fields) → the port's modules."""
    dev = resolve_device(device)
    out = build_nets(cfg, device="cpu")
    for name, net in zip(NetParams._fields, out):
        load_flax_params(net, _field(nets, name))
    return NetParams(*[n.to(dev) for n in out])


def state_from_jax(cfg: Config, gp, gs, nets, device: DeviceLike = None) -> TrainState:
    """A JAX ``TrainState``'s model leaves (numpy) → the port's state."""
    gp_t, gs_t = gaussians_from_numpy(gp, gs, device)
    return TrainState(gp=gp_t, gs=gs_t, nets=nets_from_flax(cfg, nets, device))
