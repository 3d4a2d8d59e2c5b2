"""Entry points: the mesh-phase forward with its losses, and a multi-device
dry run of the training step.

Counterpart of __graft_entry__.py (``_tiny_cfg``, ``_dryrun_cfg``,
``_make_state_and_batch``, ``entry`` :80, ``dryrun_multichip`` :102).  Both
run on the card unless the caller asks for the CPU (``device="cpu"``).

  python -c "from dgmesh_torch.graft_entry import dryrun_multichip as d; \\
             d(2, device='cpu')"

runs one sharded step over two gloo ranks on the CPU.  On one card with two
ranks: ``d(2, device='cuda:0', backend='gloo')`` (NCCL refuses two ranks on
one card); on n cards: ``d(n)`` (NCCL, rank r on card r).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .config import Config
from .device import DeviceLike, resolve_device

FLAGS = dict(warm=False, mesh=True, freeze_pos=False, use_normal=True, sh_degree=1)


def _tiny_cfg(grid_res: int = 32, max_g: int = 512, img: int = 64):
    """The miniature configuration: grid 32, 512 Gaussian slots, 64², small
    capacities."""
    cfg = Config()
    cfg.model.is_blender = True
    cfg.model.grid_res = grid_res
    cfg.model.sh_degree = 1
    cfg.optimization.dpsr_sig = 2.0
    t = cfg.tpu
    t.max_gaussians = max_g
    t.max_verts = 4096
    t.max_faces = 8192
    t.max_gaussians_per_tile = 64
    t.max_dup = 1 << 12
    t.max_faces_per_tile = 32
    t.max_face_dup = 1 << 12
    t.tile_chunk = 8
    return cfg, img


def _dryrun_cfg(n_devices: int = 8):
    """The dry run's shapes: grid 64, 64², max(16384, 1024·n) Gaussian
    slots, so the Gaussian axis really splits (2k rows a rank at n = 8) and
    the radius-0.4 shell meshes to ~13k vertices."""
    cfg, img = _tiny_cfg(grid_res=64, max_g=max(16_384, 1024 * n_devices), img=64)
    t = cfg.tpu
    t.max_verts = 16_384
    t.max_faces = 32_768
    t.max_gaussians_per_tile = 64
    t.max_dup = 1 << 14
    t.max_faces_per_tile = 32
    t.max_face_dup = 1 << 14
    t.tile_chunk = 16
    return cfg, img


def _make_state_and_batch(cfg: Config, img: int, device: DeviceLike = None):
    """(ctx, state, batch): half the slots live on a radius-0.4 sphere with
    outward normals (so the DPSR yields a real surface), the camera at
    distance 2.5, a random image, from numpy's seed 0 and torch's seed 0."""
    from .cameras import camera_from_c2w_blender
    from .train.state import init_state
    from .train.step import StepContext, make_batch

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n = cfg.tpu.max_gaussians // 2
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (0.4 * d).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    state = init_state(cfg, pts, cols, device=dev)
    d_pad = np.zeros((cfg.tpu.max_gaussians, 3), np.float32)
    d_pad[:n] = d
    normal = torch.as_tensor(d_pad, device=dev) * state.gs.alive[:, None]
    state = state._replace(gp=state.gp._replace(normal=normal))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    cam = camera_from_c2w_blender(0, c2w, 0.9, img, img, 0.3,
                                  image=rng.random((img, img, 3)).astype(np.float32),
                                  alpha_mask=np.ones((img, img, 1), np.float32))
    batch = make_batch(cam, 0.05, np.zeros(3, np.float32), device=dev)
    return StepContext(cfg, img, img, device=dev), state, batch


def entry(device: DeviceLike = None):
    """(fn, args): the mesh-phase forward with its losses on the miniature
    configuration, ``fn(*args)`` the total loss."""
    from .train.step import StepFlags, loss_and_aux

    cfg, img = _tiny_cfg()
    ctx, state, batch = _make_state_and_batch(cfg, img, device)
    flags = StepFlags(**FLAGS)

    def fn(gp, nets, gs, batch):
        M = gp.xyz.shape[0]
        loss, _ = loss_and_aux(ctx, gp, nets, gp.xyz.new_zeros((M, 2)), gs, batch,
                               torch.tensor(100.0, device=gp.xyz.device), flags)
        return loss

    return fn, (state.gp, state.nets, state.gs, batch)


def _dryrun_rank(mesh, n_devices: int):
    """One rank of the dry run: its part of the state, one sharded step."""
    from .parallel.sharding import shard_state
    from .train.step import StepContext, StepFlags, train_step

    cfg, img = _dryrun_cfg(n_devices)
    _, state, batch = _make_state_and_batch(cfg, img, mesh.device)
    ctx = StepContext(cfg, img, img, device=mesh.device, device_mesh=mesh)
    state = shard_state(state, mesh)
    _, metrics = train_step(ctx, state, batch, StepFlags(**FLAGS))
    return {k: float(v) for k, v in metrics.items()}


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     backend: Optional[str] = None) -> dict:
    """Spawn n ranks, run one sharded training step at the dry run's shapes,
    assert a finite loss; returns rank 0's metrics.

    ``device``: "cuda" (the default: rank r on card r), "cuda:K" (every rank
    on card K) or "cpu".  ``backend``: "nccl" on CUDA and "gloo" on the CPU
    by default; ranks that share a card need ``backend="gloo"``."""
    from .parallel.sharding import spawn

    device = device or "cuda"
    backend = backend or ("gloo" if torch.device(device).type == "cpu" else "nccl")
    out = spawn(_dryrun_rank, n_devices, backend, device, args=(n_devices,),
                threads=1 if device == "cpu" else None)
    loss = out[0]["loss"]
    assert math.isfinite(loss), f"non-finite loss in the multi-device dry run: {loss}"
    assert all(o["loss"] == loss for o in out), "the ranks disagree on the loss"
    print(f"dryrun_multichip({n_devices}) OK: loss={loss:.4f}, backend {backend}, "
          f"device {device}, V {int(out[0]['mesh_n_verts'])}")
    return out[0]
