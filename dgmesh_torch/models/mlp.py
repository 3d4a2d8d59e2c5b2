"""Deformation / appearance MLPs as ``nn.Module``s.

Counterpart of dgmesh_tpu/models/mlp.py (reference utils/time_utils.py:
Embedder :7-55, DeformNetwork :58-204, DeformNetworkNormalSep :207-266,
AppearanceNetwork :269-323).  Layers are named after their role; convert.py
maps flax's names (``Dense_0``…, ``MLPTrunk_0``) onto them.

Parameters are float32.  ``mode`` picks the trunk's arithmetic, as the JAX
nets' ``dtype``/``fuse`` do: ``"f32"``; ``"bf16"`` (operands, products and
bias add in bf16, the blender timenet too); ``"fused"`` (the bf16 trunk in
one kernel per direction, ops/mlp_fused.py; the timenet as in ``"bf16"``).
The heads and the trunk's output are float32 in every mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.mlp_fused import FusedTrunk, pack_trunk
from ..ops.rigid import se3_transform_points

MODES = ("f32", "bf16", "fused")


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF encoding with frequencies 2^0..2^(L-1): [x, sin, cos] per frequency."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * freqs[:, None]             # (..., L, d)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])   # also for 0 rows
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

    def forward(self, inp: torch.Tensor, mode: str = "f32") -> torch.Tensor:
        din = inp.shape[-1]
        width = self.layers[0].out_features
        if mode == "fused" and width == 256 and din <= 256:
            return FusedTrunk.apply(inp, *pack_trunk(self, din))
        if mode == "f32":
            h = inp
            for i, layer in enumerate(self.layers):
                x_in = torch.cat([inp, h], dim=-1) if i == self.skip + 1 else h
                h = F.relu(layer(x_in))
            return h
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        # "bf16" (and "fused" where the kernel does not apply, as in JAX):
        # flax's dense with dtype bf16 (dgmesh_tpu/models/mlp.py:89-104)
        h = inp.to(torch.bfloat16)
        for i, layer in enumerate(self.layers):
            x_in = torch.cat([inp.to(torch.bfloat16), h], dim=-1) if i == self.skip + 1 else h
            h = F.relu(dense_bf16(layer, x_in))
        return h.float()


def dense_bf16(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Dense with operands, product and bias add in bf16, the bias as a
    second op (flax's ``nn.Dense(dtype=bf16)`` and the JAX trunk's dense)."""
    return x.to(torch.bfloat16) @ layer.weight.to(torch.bfloat16).t() \
        + layer.bias.to(torch.bfloat16)


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

    def features(self, xyz: torch.Tensor, t: torch.Tensor, mode: str = "f32") -> torch.Tensor:
        t_emb = positional_encoding(t, self.t_multires)
        if self.is_blender:
            if mode == "f32":
                t_emb = self.timenet1(F.relu(self.timenet0(t_emb)))
            else:   # flax's Dense(dtype=bf16) timenet, cast back to float32
                t_emb = dense_bf16(self.timenet1, F.relu(dense_bf16(self.timenet0, t_emb)))
                t_emb = t_emb.float()
        x_emb = positional_encoding(xyz, self.multires)
        return self.trunk(torch.cat([x_emb, t_emb], dim=-1), mode)


class DeformNetwork(_TimeConditioned):
    """Canonical↔deformed offsets: d_xyz, d_rotation, d_scaling[, d_normal].

    With ``is_6dof`` the position offset comes from a screw motion (the
    reference's time_utils.py:100-124, dgmesh_tpu/models/mlp.py:150-162):
    ``head_w`` and ``head_v`` (flax's default Dense init, not zero) give w
    and v, θ = ‖w‖, and d_xyz is the SE(3)-moved point less the point."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 is_blender: bool = False, with_normal: bool = False,
                 is_6dof: bool = False, zero_init_heads: bool = True,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__(is_blender, depth, width, multires, gen, device)
        self.with_normal = with_normal
        self.is_6dof = is_6dof
        z = zero_init_heads
        if is_6dof:
            self.head_w = Dense(width, 3, gen=gen, device=device)
            self.head_v = Dense(width, 3, gen=gen, device=device)
        else:
            self.head_xyz = Dense(width, 3, zero=z, gen=gen, device=device)
        self.head_rot = Dense(width, 4, zero=z, gen=gen, device=device)
        self.head_scale = Dense(width, 3, zero=z, gen=gen, device=device)
        if with_normal:
            self.head_normal = Dense(width, 3, zero=z, gen=gen, device=device)

    def forward(self, xyz, t, mode: str = "f32"):
        h = self.features(xyz, t, mode)
        d_xyz = self._screw(xyz, h) if self.is_6dof else self.head_xyz(h)
        out = (d_xyz, self.head_rot(h), self.head_scale(h))
        if self.with_normal:
            return out + (self.head_normal(h),)
        return out


    def _screw(self, xyz, h):
        w, v = self.head_w(h), self.head_v(h)
        # θ = sqrt(Σ w²), JAX's norm: at w = 0 (a row whose trunk output is
        # all zero, so w is the bias) its gradient is NaN, as jax.grad of
        # jnp.linalg.norm gives; torch.linalg.vector_norm would give 0
        theta = torch.sqrt((w * w).sum(-1, keepdim=True))
        screw = torch.cat([w / (theta + 1e-5), v / (theta + 1e-5)], -1)
        return se3_transform_points(xyz, screw, theta) - xyz


class DeformNetworkNormalSep(_TimeConditioned):
    """Normal-offset-only network with a zero-initialised head."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 is_blender: bool = False, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(is_blender, depth, width, multires, gen, device)
        self.head_normal = Dense(width, 3, zero=True, gen=gen, device=device)

    def forward(self, xyz, t, mode: str = "f32"):
        return self.head_normal(self.features(xyz, t, mode))


class AppearanceNetwork(_TimeConditioned):
    """Vertex colour field (canonical xyz, t) → sigmoid RGB."""

    def __init__(self, depth: int = 8, width: int = 256, multires: int = 10,
                 is_blender: bool = False, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__(is_blender, depth, width, multires, gen, device)
        self.head_rgb = Dense(width, 3, gen=gen, device=device)

    def forward(self, xyz, t, mode: str = "f32"):
        return torch.sigmoid(self.head_rgb(self.features(xyz, t, mode)))
