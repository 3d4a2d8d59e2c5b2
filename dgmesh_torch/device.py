"""Device resolution and the float32 precision switches.

Every entry point of the port runs on ``cuda`` unless the caller asks for the
CPU (``device="cpu"``, as the tests do).  There is no silent fallback: asking
for the default device on a machine without a GPU raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_precision() -> None:
    """Pin float32 math to full float32 on the card.

    The JAX reference pins ``Precision.HIGHEST`` on every geometry matmul and
    runs the nets in f32 on the render path; TF32 (about three decimal
    digits) would move projected pixels and z-buffer winners.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raise without a GPU."""
    set_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dgmesh_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly")
    return dev
