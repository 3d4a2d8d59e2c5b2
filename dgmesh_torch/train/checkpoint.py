"""Checkpoint and resume.

Counterpart of dgmesh_tpu/train/checkpoint.py.  ``save_checkpoint`` writes
the port's own ``checkpoint/state_N.pt``: ``torch.save`` of plain dicts of
tensors (the Gaussian leaves, their Adam moments and count, each net's
``state_dict`` and Adam moments, the step), read back with
``weights_only=True``; and, as the reference does (scene/__init__.py:129-131,
deform_model.py:30-41), ``point_cloud/iteration_N/point_cloud.ply`` and one
file per net, ``<net>/iteration_N/<net>.pt``.  ``load_checkpoint`` reads
the port's file; where only the JAX package's ``state_N.msgpack`` exists
(flax.serialization's bytes of its TrainState), it decodes that with the
msgpack reader below and carries it across with convert.state_from_jax.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from ..models import gaussians as G
from .state import NetAdam, NetParams, TrainState, build_nets


def _state_dict(state: TrainState) -> dict:
    leaves = lambda tup: {f: getattr(tup, f) for f in tup._fields}  # noqa: E731
    return dict(
        gp=leaves(state.gp), gs=leaves(state.gs), g_mu=leaves(state.g_mu),
        g_nu=leaves(state.g_nu), g_count=state.g_count, step=state.step,
        nets={n: getattr(state.nets, n).state_dict() for n in NetParams._fields},
        net_opt={n: dict(count=o.count, mu=list(o.mu), nu=list(o.nu))
                 for n, o in zip(NetParams._fields, state.net_opt)})


def save_checkpoint(state: TrainState, model_path: str, iteration: int):
    ckpt_dir = os.path.join(model_path, "checkpoint")
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(_state_dict(state), os.path.join(ckpt_dir, f"state_{iteration}.pt"))
    G.save_ply(os.path.join(model_path, "point_cloud", f"iteration_{iteration}",
                            "point_cloud.ply"), state.gp, state.gs)
    for name in NetParams._fields:
        net_dir = os.path.join(model_path, name, f"iteration_{iteration}")
        os.makedirs(net_dir, exist_ok=True)
        torch.save(getattr(state.nets, name).state_dict(), os.path.join(net_dir, f"{name}.pt"))


def search_max_iteration(folder: str) -> Optional[int]:
    """reference: utils/system_utils.py searchForMaxIteration :29-31."""
    if not os.path.isdir(folder):
        return None
    iters = [int(m.group(1)) for m in (re.search(r"(\d+)", n) for n in os.listdir(folder)) if m]
    return max(iters) if iters else None


def _state_from_dict(cfg: Config, d: dict, device) -> TrainState:
    nets = build_nets(cfg, device=device)
    for name, net in zip(NetParams._fields, nets):
        net.load_state_dict(d["nets"][name])
    tup = lambda cls, leaves: cls(*[leaves[f] for f in cls._fields])  # noqa: E731
    return TrainState(
        gp=tup(G.GaussianParams, d["gp"]), gs=tup(G.GaussianStats, d["gs"]), nets=nets,
        g_mu=tup(G.GaussianParams, d["g_mu"]), g_nu=tup(G.GaussianParams, d["g_nu"]),
        g_count=d["g_count"],
        net_opt=NetParams(*[NetAdam(o["count"], tuple(o["mu"]), tuple(o["nu"]))
                            for o in (d["net_opt"][n] for n in NetParams._fields)]),
        step=d["step"])


def load_checkpoint(cfg: Config, model_path: str, iteration: int = -1,
                    device: DeviceLike = None) -> TrainState:
    """The state at ``iteration`` (the latest with -1) under
    ``model_path/checkpoint``: the port's ``state_N.pt``, else JAX's
    ``state_N.msgpack``."""
    dev = resolve_device(device)
    ckpt_dir = os.path.join(model_path, "checkpoint")
    if iteration == -1:
        iteration = search_max_iteration(ckpt_dir)
        if iteration is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    pt = os.path.join(ckpt_dir, f"state_{iteration}.pt")
    if os.path.exists(pt):
        return _state_from_dict(cfg, torch.load(pt, map_location=dev, weights_only=True), dev)
    mp = os.path.join(ckpt_dir, f"state_{iteration}.msgpack")
    if not os.path.exists(mp):
        raise FileNotFoundError(f"neither {pt} nor {mp} exists")
    from ..convert import state_from_jax
    with open(mp, "rb") as f:
        return state_from_jax(cfg, flax_msgpack_restore(f.read()), dev)


# --- flax's msgpack format, read without msgpack or flax -------------------------
# flax.serialization.to_bytes: msgpack of the state dict (NamedTuples become
# maps by field name, tuples and lists maps keyed "0", "1", ...), with each
# array as ext type 1 holding msgpack (shape, dtype name, C-order bytes) and
# each numpy scalar as ext type 3 (the same, 0-d); arrays over 1 GiB are
# split into {"__msgpack_chunked_array__", "shape", "chunks"} maps.

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, blob: bytes):
        self.b = memoryview(blob)
        self.i = 0

    def take(self, n: int) -> memoryview:
        out = self.b[self.i:self.i + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated data")
        self.i += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def value(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                 0xC9: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext or c in (0xC7, 0xC8, 0xC9):
            n = fixext[c] if c in fixext else self.unpack(sizes[c])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        n = self.unpack(sizes[c]) if c in sizes else None
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(n))
        if c in (0xD9, 0xDA, 0xDB):
            return str(self.take(n), "utf-8")
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(n)
        raise ValueError(f"msgpack: unknown type byte {c:#x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype, buf = _Reader(data).value()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        raise ValueError("msgpack: bfloat16 arrays are not read (the JAX state keeps "
                         "float32 parameters)")
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re_, im = _Reader(data).value()
        return complex(re_, im)
    raise ValueError(f"msgpack: unknown ext type {code}")


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def flax_msgpack_restore(blob: bytes):
    """flax.serialization.msgpack_restore's tree (nested dicts of numpy
    arrays and scalars), read by the port's own decoder."""
    r = _Reader(blob)
    tree = r.value()
    if r.i != len(blob):
        raise ValueError("msgpack: trailing bytes")
    return _unchunk(tree)
