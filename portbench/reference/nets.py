"""The five DG-Mesh networks as plain functions of their weight tensors.

Upstream's ``utils/time_utils.py`` (Embedder, DeformNetwork,
DeformNetworkNormalSep, AppearanceNetwork): NeRF encodings of the point
(10 frequencies) and the time (6 through the Blender timenet 13→256→30,
else 10), an 8×256 ReLU trunk that takes the encoded input again in front
of its sixth layer, and linear heads (the appearance net's through a
sigmoid).  A net is a dict ``{name: tensor}`` with the layer names of
``param_spec``; weights are (out, in).

``mode`` is the trunk's arithmetic: ``"f32"``, or ``"fused"``: the trunk's
products on bf16 operands with float32 sums (``trunk.py``, the twins of
the program's kernels 5 and 6) and the Blender timenet in bf16; the heads
stay float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import trunk as T

NETS = ("deform", "deform_normal", "deform_back", "deform_back_normal", "appearance")
HEADS = {"deform": (("head_xyz", 3), ("head_rot", 4), ("head_scale", 3), ("head_normal", 3)),
         "deform_normal": (("head_normal", 3),),
         "appearance": (("head_rgb", 3),)}
HEADS["deform_back"] = HEADS["deform"]
HEADS["deform_back_normal"] = HEADS["deform_normal"]
# heads that start at zero (the offsets); the colour head does not
ZERO_HEADS = ("head_xyz", "head_rot", "head_scale", "head_normal")
WIDTH, DEPTH, X_FREQS = 256, 8, 10


def time_freqs(blender: bool) -> int:
    return 6 if blender else 10


def trunk_in(blender: bool) -> int:
    """Lanes into the trunk: the encoded point and the encoded time (after
    the Blender timenet)."""
    return 3 * (2 * X_FREQS + 1) + (30 if blender else 2 * time_freqs(blender) + 1)


def param_spec(blender: bool, net: str) -> List[Tuple[str, Tuple[int, ...]]]:
    """[(name, shape)] of one net's weights, in order."""
    out = []
    if blender:
        t_in = 2 * time_freqs(True) + 1
        out += [("timenet0.weight", (256, t_in)), ("timenet0.bias", (256,)),
                ("timenet1.weight", (30, 256)), ("timenet1.bias", (30,))]
    din = trunk_in(blender)
    for i in range(DEPTH):
        d = din if i == 0 else WIDTH + (din if i == DEPTH // 2 + 1 else 0)
        out += [(f"trunk.layers.{i}.weight", (WIDTH, d)), (f"trunk.layers.{i}.bias", (WIDTH,))]
    for head, n in HEADS[net]:
        out += [(f"{head}.weight", (n, WIDTH)), (f"{head}.bias", (n,))]
    return out


def encode(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), …, sin(2^(L-1) x), cos(2^(L-1) x)]."""
    parts = [x]
    for i in range(freqs):
        parts += [torch.sin(x * 2.0 ** i), torch.cos(x * 2.0 ** i)]
    return torch.cat(parts, -1)


def linear(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    return x @ w[name + ".weight"].t() + w[name + ".bias"]


def linear_bf16(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    bf = torch.bfloat16
    return x.to(bf) @ w[name + ".weight"].to(bf).t() + w[name + ".bias"].to(bf)


def features(w: Dict[str, torch.Tensor], xyz: torch.Tensor, t: torch.Tensor, blender: bool,
             mode: str) -> torch.Tensor:
    """The trunk's output (N,256) for points (N,3) at times (N,1)."""
    te = encode(t, time_freqs(blender))
    if blender:
        if mode == "f32":
            te = linear(torch.relu(linear(te, w, "timenet0")), w, "timenet1")
        else:
            te = linear_bf16(torch.relu(linear_bf16(te, w, "timenet0")), w, "timenet1").float()
    inp = torch.cat([encode(xyz, X_FREQS), te], -1)
    names = [f"trunk.layers.{i}" for i in range(DEPTH)]
    if mode == "fused":
        wpack, bpack = T.pack_trunk([w[n + ".weight"] for n in names],
                                    [w[n + ".bias"] for n in names], inp.shape[1])
        return T.FusedTrunk.apply(inp, wpack, bpack)
    h = inp
    for i, n in enumerate(names):
        h = torch.relu(linear(torch.cat([inp, h], -1) if i == DEPTH // 2 + 1 else h, w, n))
    return h


def apply(net: str, w: Dict[str, torch.Tensor], xyz: torch.Tensor, t: torch.Tensor,
          blender: bool, mode: str = "f32"):
    """The net's heads at (xyz, t): a tuple in ``HEADS`` order, the colour
    through a sigmoid; a single head alone."""
    h = features(w, xyz, t, blender, mode)
    outs = tuple(linear(h, w, head) for head, _ in HEADS[net])
    if net == "appearance":
        return torch.sigmoid(outs[0])
    return outs if len(outs) > 1 else outs[0]
