"""dgmesh_torch — Dynamic Gaussians Mesh in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``dgmesh_tpu``, which stays in the repository as the
reference.  Module paths mirror the JAX package, so ``dgmesh_torch/ops/splat.py``
is the counterpart of ``dgmesh_tpu/ops/splat.py``.  This package imports torch
and numpy only; it never imports JAX or anything of ``dgmesh_tpu``.

Entry point: ``dgmesh_torch.eval.testing.render_frame`` (deform MLPs →
Gaussian splat → DPSR → marching tets → appearance MLP → mesh raster).
Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
