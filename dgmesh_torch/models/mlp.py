"""Deformation / appearance MLPs as ``nn.Module``s, float32.

Counterpart of dgmesh_tpu/models/mlp.py (reference utils/time_utils.py:
Embedder :7-55, DeformNetwork :58-204, DeformNetworkNormalSep :207-266,
AppearanceNetwork :269-323).  Layers are named after their role; convert.py
maps flax's names (``Dense_0``…, ``MLPTrunk_0``) onto them.  The ``is_6dof``
screw head is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF encoding with frequencies 2^0..2^(L-1): [x, sin, cos] per frequency."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]             # (..., L, d)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: Optional[torch.Generator]) -> None:
    """flax's lecun_normal: truncated normal (±2σ) with variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class Dense(nn.Linear):
    """``nn.Linear`` initialised like flax's ``Dense`` (lecun-normal kernel,
    zero bias), or all zeros for the identity-start heads."""

    def __init__(self, din: int, dout: int, zero: bool = False,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__(din, dout, device=device)
        with torch.no_grad():
            self.bias.zero_()
            if zero:
                self.weight.zero_()
            else:
                _lecun_normal_(self.weight, din, gen)


class MLPTrunk(nn.Module):
    """depth×width ReLU trunk; at layer depth//2 + 1 the input is concatenated
    in front of the hidden state ([input, h]), as in the JAX trunk."""

    def __init__(self, din: int, depth: int = 8, width: int = 256,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.skip = depth // 2
        layers = []
        for i in range(depth):
            d_in = din if i == 0 else width
            if i == self.skip + 1:
                d_in += din
            layers.append(Dense(d_in, width, gen=gen, device=device))
        self.layers = nn.ModuleList(layers)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        h = inp
        for i, layer in enumerate(self.layers):
            x_in = torch.cat([inp, h], dim=-1) if i == self.skip + 1 else h
            h = F.relu(layer(x_in))
        return h


class _TimeConditioned(nn.Module):
    """Shared front end: encode (xyz, t), the blender timenet, the trunk."""

    def __init__(self, is_blender: bool, depth: int, width: int, multires: int,
                 gen: Optional[torch.Generator], device):
        super().__init__()
        self.is_blender = is_blender
        self.multires = multires
        self.t_multires = 6 if is_blender else 10
        t_dim = 2 * self.t_multires + 1
        if is_blender:
            self.timenet0 = Dense(t_dim, 256, gen=gen, device=device)
            self.timenet1 = Dense(256, 30, gen=gen, device=device)
            t_dim = 30
        self.trunk = MLPTrunk(3 * (2 * multires + 1) + t_dim, depth, width,
                              gen=gen, device=device)

    def features(self, xyz: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        t_emb = positional_encoding(t, self.t_multires)
        if self.is_blender:
            t_emb = self.timenet1(F.relu(self.timenet0(t_emb)))
        x_emb = positional_encoding(xyz, self.multires)
        return self.trunk(torch.cat([x_emb, t_emb], dim=-1))


class DeformNetwork(_TimeConditioned):
    """Canonical↔deformed offsets: d_xyz, d_rotation, d_scaling[, d_normal]."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 is_blender: bool = False, with_normal: bool = False,
                 is_6dof: bool = False, zero_init_heads: bool = True,
                 gen: Optional[torch.Generator] = None, device=None):
        if is_6dof:
            raise NotImplementedError("the is_6dof screw head is not ported yet")
        super().__init__(is_blender, depth, width, multires, gen, device)
        self.with_normal = with_normal
        z = zero_init_heads
        self.head_xyz = Dense(width, 3, zero=z, gen=gen, device=device)
        self.head_rot = Dense(width, 4, zero=z, gen=gen, device=device)
        self.head_scale = Dense(width, 3, zero=z, gen=gen, device=device)
        if with_normal:
            self.head_normal = Dense(width, 3, zero=z, gen=gen, device=device)

    def forward(self, xyz, t):
        h = self.features(xyz, t)
        out = (self.head_xyz(h), self.head_rot(h), self.head_scale(h))
        if self.with_normal:
            return out + (self.head_normal(h),)
        return out


class DeformNetworkNormalSep(_TimeConditioned):
    """Normal-offset-only network with a zero-initialised head."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 is_blender: bool = False, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(is_blender, depth, width, multires, gen, device)
        self.head_normal = Dense(width, 3, zero=True, gen=gen, device=device)

    def forward(self, xyz, t):
        return self.head_normal(self.features(xyz, t))


class AppearanceNetwork(_TimeConditioned):
    """Vertex colour field (canonical xyz, t) → sigmoid RGB."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 is_blender: bool = False, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(is_blender, depth, width, multires, gen, device)
        self.head_rgb = Dense(width, 3, gen=gen, device=device)

    def forward(self, xyz, t):
        return torch.sigmoid(self.head_rgb(self.features(xyz, t)))
