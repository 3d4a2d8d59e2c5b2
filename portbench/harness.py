"""What every cell shares: the device record, the profiled sub-window and
its reading, synchronised timers around the program's stages, the counts
of needed work taken beside the kernels, and the check that no JAX module
was loaded.

Tracing lives here, in the benchmark's own files: the program has no spans,
so the per-layer metrics come from the profiler's kernel intervals (kernel
names) and from wrappers that time or count around the program's own
functions.  Wrappers are put in place only in a ``--trace 1`` run, after the
timed window.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import re
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dgmesh_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
WINDOW_LABEL = "portbench.profiled"


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``dgmesh_torch`` is not ``dgmesh_tpu``)."""
    return sorted({k for k in sys.modules if k.split(".")[0] in FORBIDDEN})


def device_record(count: int, device) -> dict:
    """The device line of the result; on the CPU (the tests' runs) it says
    so and reads no memory."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Trace:
    """The device's intervals and the host's operations of one profiled
    sub-window, in seconds."""

    def __init__(self, events: List[dict]):
        win = [e for e in events if e.get("name") == WINDOW_LABEL and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
        if not win:
            raise RuntimeError("the profiler trace holds no window annotation")
        w = max(win, key=lambda e: e["dur"])
        self.t0, self.t1 = w["ts"], w["ts"] + w["dur"]
        self.window_s = w["dur"] * 1e-6
        self.device = [(e["name"], e["ts"], e["dur"]) for e in events
                       if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
                       and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.host = [(e["name"], e["ts"], e["dur"]) for e in events
                     if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                     and e["name"] != WINDOW_LABEL
                     and e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.busy = self._merged()
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6

    def _merged(self):
        iv = sorted((max(ts, self.t0), min(ts + dur, self.t1)) for _, ts, dur in self.device)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_seconds(self, pattern: str) -> float:
        """Seconds of device work whose name matches ``pattern`` (a regular
        expression, searched case-insensitively)."""
        rx = re.compile(pattern, re.I)
        return sum(dur for name, _, dur in self.device if rx.search(name)) * 1e-6

    def top_ops(self, n: int = 10):
        tot: Dict[str, float] = defaultdict(float)
        for name, _, dur in self.device:
            tot[name[:200]] += dur * 1e-6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The idle stretches of the device, summed by the innermost host
        operation running at each one's middle."""
        gaps, last = [], self.t0
        for a, b in self.busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if self.t1 > last:
            gaps.append((last, self.t1))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            inner = None
            for name, ts, dur in host[max(0, i - 4000):i]:
                if ts <= mid <= ts + dur and (inner is None or dur < inner[1]):
                    inner = (name, dur)
            tot[(inner[0] if inner else "host (no operation)")[:200]] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in tot.items()), key=lambda kv: -kv[1])[:n]


def profiled(fn: Callable[[], None], device, out_dir: str) -> Trace:
    """Run ``fn`` under torch.profiler (host and device activities) between
    two synchronisations; the trace goes to ``out_dir`` and is read back."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_LABEL):
            fn()
            sync(device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    return Trace(events)


class Timers:
    """Synchronised wall-clock timers put around functions of the program
    (module attributes), kept until ``restore``."""

    def __init__(self, device):
        self.device = device
        self.ms: Dict[str, List[float]] = defaultdict(list)
        self._saved = []

    def wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))
        dev = self.device

        @functools.wraps(fn)
        def timed(*a, **kw):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync(dev)
            self.ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(owner, attr, timed)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


class Counter:
    """Counts of the needed work kept as device tensors beside the program's
    kernel wrappers (no synchronisation), summed once profiling ends."""

    def __init__(self):
        self.calls: Dict[str, List] = defaultdict(list)
        self._saved = []

    def wrap(self, owner, attr: str, name: str, count: Callable) -> None:
        fn = getattr(owner, attr)
        self._saved.append((owner, attr, fn))

        @functools.wraps(fn)
        def counted(*a, **kw):
            self.calls[name].append(count(*a, **kw))
            return fn(*a, **kw)
        setattr(owner, attr, counted)

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def totals(self) -> Dict[str, Dict[str, float]]:
        """{name: {key: sum over the calls}} as host numbers."""
        out = {}
        for name, recs in self.calls.items():
            acc: Dict[str, float] = defaultdict(float)
            for r in recs:
                for k, v in r.items():
                    acc[k] += float(v)
            acc["calls"] = len(recs)
            out[name] = dict(acc)
        return out


def count_rows(valid_lane: int, backward: bool = False):
    """A Counter count for a tile kernel's wrapper, ``f(attrs, tiles_x,
    tile_h, tile_w, ...)`` or with ``backward`` ``f(attrs, g_rgb, g, ...)``:
    the valid rows, the pixels and the (pixel, valid row) pairs of the
    call."""
    def count(attrs, *a, **kw):
        px = a[0].shape[1] if backward else a[1] * a[2]
        rows = (attrs[..., valid_lane] > 0).sum()
        return {"rows": rows, "pixels": attrs.shape[0] * px, "pairs": rows * px}
    return count


def read_metrics(spec, metrics, rec: dict) -> Dict[str, dict]:
    """Each metric's reader on the run's record; a reader that finds nothing
    to read returns None, and the metric is left out."""
    out = {}
    for m in metrics:
        v = spec.reader(m["name"]).read(m["name"], rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def quantile(xs: List[float], q: float) -> float:
    """The q-quantile of xs by linear interpolation between order statistics."""
    s = sorted(xs)
    if not s:
        raise ValueError("no samples")
    pos = q * (len(s) - 1)
    i = int(pos)
    j = min(i + 1, len(s) - 1)
    return s[i] + (s[j] - s[i]) * (pos - i)


def stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def clear_program_state() -> None:
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def lowered(mode: str):
    """The reference at the precision below the configuration's, the control:
    TF32 products for float32 nets, float8 (e4m3) trunk products for bf16
    ones."""
    from portbench.reference import step as RS
    from portbench.reference import trunk
    if mode == "f32":
        RS.full_float32(False)
    else:
        trunk.PRODUCT_DTYPE = torch.float8_e4m3fn
    try:
        yield
    finally:
        RS.full_float32(True)
        trunk.PRODUCT_DTYPE = torch.bfloat16


@contextlib.contextmanager
def half_batch():
    """A fault planted in the reference: the image losses over the top half
    of the rows only, the mean taken over the rest."""
    from portbench.reference import step as RS
    orig = RS.image_loss

    def half(img, gt, lam):
        h = img.shape[-2] // 2
        return orig(img[..., :h, :], gt[..., :h, :], lam)
    RS.image_loss = half
    try:
        yield
    finally:
        RS.image_loss = orig
