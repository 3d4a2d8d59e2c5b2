"""Shared fixture for the port's parity tests: the miniature JAX state of
``__graft_entry__._make_state_and_batch`` (grid 32, 512 Gaussian slots, 64²,
Pallas kernels in interpret mode) with seeded noise on the zero-initialised
network heads, and the same state carried into the port by convert.py."""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__ as ge  # noqa: E402


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def perturb_flax_heads(nets, rng, std):
    """Numpy noise on every all-zero Dense kernel/bias of the flax trees."""
    def walk(t):
        if isinstance(t, dict) and "kernel" in t:
            if not np.any(t["kernel"]):
                return {"kernel": rng.normal(0, std, t["kernel"].shape).astype(np.float32),
                        "bias": rng.normal(0, std, t["bias"].shape).astype(np.float32)}
            return t
        if isinstance(t, dict):
            return {k: walk(v) for k, v in sorted(t.items())}
        return t
    return type(nets)(*[walk(n) for n in to_numpy(nets)])


# capacities at which the fixture's sphere meshes whole and covers ~8% of
# the image (the miniature config's own caps drop most of the surface);
# back faces culled as in the shipped recipes
ROOMY = dict(max_verts=16384, max_faces=32768, max_faces_per_tile=1024,
             max_face_dup=1 << 16, mr_cull_backface=True)


def jax_fixture(head_std=1e-3, seed=0, is_blender=True, **caps):
    """(cfg, img, ctx, state, batch) on the JAX side, Pallas kernels on;
    ``caps`` override TpuParams capacities.  ``is_blender=False`` gives the
    nets of real captures (no timenet) and the step's time noise."""
    cfg, img = ge._tiny_cfg()
    cfg.model.is_blender = is_blender
    cfg.tpu.use_pallas = True
    for k, v in caps.items():
        setattr(cfg.tpu, k, v)
    ctx, state, batch = ge._make_state_and_batch(cfg, img)
    nets = perturb_flax_heads(state.nets, np.random.default_rng(seed), head_std)
    state = state._replace(nets=jax.tree.map(jnp.asarray, nets))
    return cfg, img, ctx, state, batch


def port_fixture(cfg, img, state):
    """The same state, camera and batch in the port, on the CPU."""
    from dgmesh_torch import convert
    from dgmesh_torch.cameras import camera_from_c2w_blender
    from dgmesh_torch.config import Config
    from dgmesh_torch.train.step import StepContext, make_batch

    tcfg = Config.from_dict(cfg.to_dict())
    tstate = convert.state_from_jax(tcfg, to_numpy(state), device="cpu")
    # the camera of _make_state_and_batch
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    cam = camera_from_c2w_blender(0, c2w, 0.9, img, img, 0.3)
    tbatch = make_batch(cam, 0.05, np.zeros(3, np.float32), device="cpu")
    return tcfg, StepContext(tcfg, img, img, device="cpu"), tstate, tbatch


def t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def port_batch(batch):
    """A JAX ``Batch`` (its camera arrays, GT image and mask) as the port's."""
    from dgmesh_torch.ops.splat import CameraArrays
    from dgmesh_torch.train.step import Batch
    b = to_numpy(batch)
    return Batch(cam=CameraArrays(*[t(x) for x in b.cam]),
                 **{f: t(getattr(b, f)) for f in Batch._fields if f != "cam"})
