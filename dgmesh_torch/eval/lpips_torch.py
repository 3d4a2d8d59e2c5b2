"""LPIPS perceptual metric (reference utils/metric_utils.py rgb_lpips :18-23;
train.py:646-697 reports LPIPS(alex, vgg) for the GS and mesh renders).

Counterpart of dgmesh_tpu/eval/lpips_jax.py: the same AlexNet and VGG16
feature stacks, input scaling layer and unit-normalised, linear-head
readout, over ``F.conv2d`` and ``F.max_pool2d``, on the images' device.
The weights are the same ``lpips_<net>.npz`` files, found in the same
order (``DGMESH_LPIPS_WEIGHTS_<NET>``, ``DGMESH_LPIPS_WEIGHTS``,
``$DGMESH_LPIPS_DIR/lpips_<net>.npz``, ``~/.cache/dgmesh_tpu/``), so one
converted file serves both packages.  Nothing is downloaded: without a
file, ``rgb_lpips`` returns NaN and the test pass reports no LPIPS column.

Converting the pretrained weights needs the ``lpips`` package (and its
download), on a machine that has them:

    python -c "from dgmesh_torch.eval.lpips_torch import convert_torch_lpips; \\
               convert_torch_lpips('lpips_alex.npz', 'alex'); \\
               convert_torch_lpips('lpips_vgg.npz', 'vgg')"

``random_weights`` writes schema-correct random files for plumbing tests.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

_CACHE: Dict = {}


def _weights_path(net: str) -> Optional[str]:
    cand = [os.environ.get(f"DGMESH_LPIPS_WEIGHTS_{net.upper()}", ""),
            os.environ.get("DGMESH_LPIPS_WEIGHTS", ""),
            os.path.join(os.environ.get("DGMESH_LPIPS_DIR", ""), f"lpips_{net}.npz")
            if os.environ.get("DGMESH_LPIPS_DIR") else "",
            os.path.expanduser(f"~/.cache/dgmesh_tpu/lpips_{net}.npz")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    return None


def lpips_available(net: str = "alex") -> bool:
    return _weights_path(net) is not None


def _alex_features(x, p):
    """AlexNet trunk (5 conv stages) returning per-stage activations."""
    acts = []
    y = F.relu(F.conv2d(x, p["conv1_w"], p["conv1_b"], stride=4, padding=2))
    acts.append(y)
    y = F.max_pool2d(y, 3, 2)
    y = F.relu(F.conv2d(y, p["conv2_w"], p["conv2_b"], padding=2))
    acts.append(y)
    y = F.max_pool2d(y, 3, 2)
    for i in (3, 4, 5):
        y = F.relu(F.conv2d(y, p[f"conv{i}_w"], p[f"conv{i}_b"], padding=1))
        acts.append(y)
    return acts


# VGG16 conv counts per stage; LPIPS taps relu{1_2,2_2,3_3,4_3,5_3}
_VGG_STAGES = (2, 2, 3, 3, 3)


def _vgg_features(x, p):
    acts = []
    y = x
    for s, n_conv in enumerate(_VGG_STAGES, 1):
        if s > 1:
            y = F.max_pool2d(y, 2, 2)
        for c in range(1, n_conv + 1):
            y = F.relu(F.conv2d(y, p[f"c{s}_{c}_w"], p[f"c{s}_{c}_b"], padding=1))
        acts.append(y)
    return acts


_SHIFT = np.array([-.030, -.088, -.188], np.float32)
_SCALE = np.array([.458, .448, .450], np.float32)


def _lpips_fn(img, gt, p, net):
    shift = torch.as_tensor(_SHIFT, device=img.device)[:, None, None]
    scale = torch.as_tensor(_SCALE, device=img.device)[:, None, None]

    def norm_input(x):
        return ((x * 2.0 - 1.0 - shift) / scale)[None]

    feat = _alex_features if net == "alex" else _vgg_features
    total = 0.0
    for i, (a, b) in enumerate(zip(feat(norm_input(img), p), feat(norm_input(gt), p))):
        a = a / (torch.linalg.vector_norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.vector_norm(b, dim=1, keepdim=True) + 1e-10)
        total = total + ((a - b) ** 2 * p[f"lin{i}_w"]).sum(dim=1).mean()
    return total


@torch.no_grad()
def rgb_lpips(img: torch.Tensor, gt: torch.Tensor, net: str = "alex") -> float:
    """img, gt: (3,H,W) in [0,1], on one device.  Returns LPIPS, or NaN
    without weights."""
    path = _weights_path(net)
    if path is None:
        return float("nan")
    key = (path, str(img.device))
    if key not in _CACHE:
        _CACHE[key] = {k: torch.as_tensor(v, device=img.device)
                       for k, v in np.load(path).items()}
    return float(_lpips_fn(img.float(), gt.float(), _CACHE[key], net))


def convert_torch_lpips(out_path: str, net: str = "alex"):
    """The ``lpips`` package's pretrained weights → npz (run where it and its
    download are at hand)."""
    try:
        import lpips as torch_lpips  # type: ignore
    except ImportError as e:
        raise ImportError("convert_torch_lpips needs the `lpips` package "
                          "(pip install lpips), which is not installed") from e
    m = torch_lpips.LPIPS(net=net)
    sd = {}
    trunk = m.net
    if net == "alex":
        convs = [trunk.slice1[0], trunk.slice2[1], trunk.slice3[1],
                 trunk.slice4[1], trunk.slice5[1]]
        for i, c in enumerate(convs, 1):
            sd[f"conv{i}_w"] = c.weight.detach().numpy()
            sd[f"conv{i}_b"] = c.bias.detach().numpy()
    elif net == "vgg":
        slices = [trunk.slice1, trunk.slice2, trunk.slice3, trunk.slice4, trunk.slice5]
        for s, sl in enumerate(slices, 1):
            convs = [mod for mod in sl if isinstance(mod, torch.nn.Conv2d)]
            assert len(convs) == _VGG_STAGES[s - 1], (s, len(convs))
            for c, conv in enumerate(convs, 1):
                sd[f"c{s}_{c}_w"] = conv.weight.detach().numpy()
                sd[f"c{s}_{c}_b"] = conv.bias.detach().numpy()
    else:
        raise ValueError(f"unsupported net {net!r}")
    for i, lin in enumerate(m.lins):
        sd[f"lin{i}_w"] = lin.model[1].weight.detach().numpy()
    np.savez(out_path, **sd)


def random_weights(out_path: str, net: str = "alex", seed: int = 0):
    """Schema-correct random weights, for plumbing tests only (the JAX
    version's arrays from the same ``default_rng(seed)`` draws)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32)

    sd = {}
    if net == "alex":
        chans = [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                 (256, 384, 3, 3), (256, 256, 3, 3)]
        for i, shp in enumerate(chans, 1):
            sd[f"conv{i}_w"] = w(*shp)
            sd[f"conv{i}_b"] = w(shp[0])
        lin_c = [64, 192, 384, 256, 256]
    elif net == "vgg":
        cin = 3
        widths = [64, 128, 256, 512, 512]
        for s, (n_conv, cout) in enumerate(zip(_VGG_STAGES, widths), 1):
            for c in range(1, n_conv + 1):
                sd[f"c{s}_{c}_w"] = w(cout, cin, 3, 3)
                sd[f"c{s}_{c}_b"] = w(cout)
                cin = cout
        lin_c = widths
    else:
        raise ValueError(net)
    for i, c in enumerate(lin_c):
        sd[f"lin{i}_w"] = np.abs(w(1, c, 1, 1))
    np.savez(out_path, **sd)
