"""The spans reader (portbench/spans.py) and the four metrics that read the
program's spans and counters, on a synthetic Chrome trace.

    python -m pytest portbench/tests -q -p no:cacheprovider

The fixture: one training iteration on a main thread (1) whose backward
runs on a second thread (2), the log's read after it, and the harness's own
synchronisation and a launch after the roots; each launch and copy issued
the device record that follows it in order, as on the program's one stream.
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import spans as S  # noqa: E402
from portbench.harness import WINDOW_LABEL, Trace  # noqa: E402
from portbench.spec import load_file  # noqa: E402


def x(name, cat, ts, dur, tid=1, **args):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid, args=args)


def span(name, ts, dur, tid=1):
    return x(name, "user_annotation", ts, dur, tid)


def call(name, ts, dur=2, tid=1, corr=None):
    return x(name, "cuda_runtime", ts, dur, tid, correlation=corr)


def device(name, ts, dur, cat="kernel", corr=None):
    return x(name, cat, ts, dur, 7, correlation=corr)


def events(with_spans=True, with_mt=True):
    ev = [span(WINDOW_LABEL, 0, 1000),
          call("cudaLaunchKernel", 40, corr=1), device("deform_gemm", 45, 10, corr=1),
          call("cudaLaunchKernel", 110, corr=2), device("mt_kernel", 115, 20, corr=2),
          call("cudaMemcpyAsync", 120, corr=3),
          device("Memcpy DtoH (Device -> Pageable)", 136, 4, "gpu_memcpy", corr=3),
          call("cudaStreamSynchronize", 121, 20),
          x("aten::nonzero", "cpu_op", 105, 40),
          call("cudaLaunchKernel", 240, tid=2, corr=4), device("composite_bwd_kernel", 245, 30,
                                                                corr=4),
          call("cudaLaunchKernel", 320, tid=2, corr=5), device("scatter_kernel", 325, 5, corr=5),
          call("cudaStreamSynchronize", 525),
          call("cudaDeviceSynchronize", 600),
          call("cudaLaunchKernel", 610, corr=6), device("harness_kernel", 615, 5, corr=6)]
    if with_spans:
        ev += [span("trainer.iteration", 10, 490), span("step.forward", 20, 180),
               span("nets.deform", 30, 50), span("step.backward", 210, 190),
               span("splat.composite_bwd", 230, 70, tid=2), span("trainer.log", 520, 20)]
        if with_mt:
            ev.append(span("mesh.marching_tets", 100, 50))
    return ev


def record(ev, kind="train"):
    return dict(kind=kind, trace=Trace(ev), work={"iterations": 1}, timers={}, step_ms=1.0)


def reader(name):
    return load_file(os.path.join(ROOT, "portbench", "metrics", name + ".py"), "r_" + name)


def readings(tr):
    return (tr.window_s, list(tr.device), list(tr.host), list(tr.busy), tr.busy_s,
            tr.kernel_seconds("kernel"), tr.top_ops(), tr.idle_gaps())


def test_trace_readings_unchanged_by_the_spans():
    """The Trace's own readings on the fixture, by hand, and the same after
    the spans are read from it."""
    tr = Trace(events())
    before = readings(tr)
    assert tr.window_s == pytest.approx(1e-3) and len(tr.device) == 6
    assert tr.busy_s == pytest.approx((10 + 20 + 4 + 30 + 5 + 5) * 1e-6)
    assert tr.kernel_seconds(r"bwd") == pytest.approx(30e-6)
    assert tr.top_ops(1) == [["composite_bwd_kernel", pytest.approx(30e-6)]]
    S.table(tr)
    assert readings(tr) == before


def test_kernel_from_the_backward_thread_goes_to_its_span():
    t = S.table(Trace(events()))
    assert t["splat.composite_bwd"]["device_ms"] == pytest.approx(0.030)
    assert t["splat.composite_bwd"]["launches"] == 1
    # launched on thread 2 outside any backward span: step.backward's own
    assert t["step.backward"]["device_ms"] == pytest.approx(0.005)
    assert t["step.backward"]["launches"] == 1
    assert t["nets.deform"]["device_ms"] == pytest.approx(0.010)
    assert t["mesh.marching_tets"]["device_ms"] == pytest.approx(0.024)
    assert t["mesh.marching_tets"]["syncs"] == 1 and t["trainer.log"]["syncs"] == 1
    assert t["trainer.iteration"]["device_ms"] == 0.0


def test_self_time_nests():
    t = S.table(Trace(events()))
    assert t["step.forward"]["self_ms"] == pytest.approx((180 - 50 - 50) * 1e-3)
    assert t["step.backward"]["self_ms"] == pytest.approx((190 - 70) * 1e-3)
    assert t["trainer.iteration"]["self_ms"] == pytest.approx((490 - 180 - 190) * 1e-3)
    assert t["trainer.iteration"]["host_ms"] == pytest.approx(0.490)
    assert t["nets.deform"]["self_ms"] == t["nets.deform"]["host_ms"]
    # the iteration's interval less the device records that ran inside it
    assert t["trainer.iteration"]["idle_ms"] == pytest.approx(
        (490 - 10 - 20 - 4 - 30 - 5) * 1e-3)


def test_calls_outside_the_roots_are_not_counted():
    """The harness's cudaDeviceSynchronize and its launch after the roots
    are left out; the log's sync is in."""
    rec = record(events())
    assert reader("launches").read("launches.train", rec) == 4
    assert reader("host_syncs").read("host_syncs.train", rec) == 2
    assert reader("mt_device_ms").read("mt_device_ms.train", rec) == pytest.approx(0.024)


def test_readers_are_silent_without_spans():
    rec = record(events(with_spans=False))
    for m in ("launches", "host_syncs", "mt_device_ms"):
        assert reader(m).read(m + ".train", rec) is None, m
    rec = record(events(with_mt=False))
    assert reader("mt_device_ms").read("mt_device_ms.train", rec) is None
    assert reader("launches").read("launches.train", rec) == 4
    # render traffic: its root is render.frame, absent here
    assert reader("launches").read("launches.render", record(events(), "render")) is None


def test_device_time_only_where_the_link_holds():
    """A device record with no call that issued it, or a copy where a
    launch stands, leaves the device time unattributed."""
    ev = events() + [device("orphan_kernel", 700, 3)]
    assert S.table(Trace(ev))["nets.deform"]["device_ms"] is None
    assert reader("mt_device_ms").read("mt_device_ms.train", record(ev)) is None
    ev = [e if e["name"] != "cudaMemcpyAsync" else call("cudaLaunchKernel", 120)
          for e in events()]
    assert S.of(Trace(ev)).issued is None
    assert reader("launches").read("launches.train", record(ev)) == 5


def test_per_profiled_iteration():
    """Two iterations: the counts are per iteration."""
    ev = events()
    shift = [dict(e, ts=e["ts"] + 1000) for e in ev if e["name"] != WINDOW_LABEL]
    ev = [span(WINDOW_LABEL, 0, 2000)] + [e for e in ev if e["name"] != WINDOW_LABEL] + shift
    rec = record(ev)
    assert reader("launches").read("launches.train", rec) == 4
    assert reader("host_syncs").read("host_syncs.train", rec) == 2
    assert reader("mt_device_ms").read("mt_device_ms.train", rec) == pytest.approx(0.024)


def test_net_live_share_reads_the_program_counters():
    from torch.profiler import ProfilerActivity, profile

    from dgmesh_torch import tracing
    r = reader("net_live_share")
    tracing.reset()
    assert r.read("net_live_share.train", record(events())) is None
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("nets.rows.deform", 8)
        tracing.count("nets.live_rows.deform", 3)
        tracing.count("nets.rows.appearance", 2)
        tracing.count("nets.live_rows.appearance", 2)
    try:
        assert r.read("net_live_share.train", record(events())) == pytest.approx(50.0)
    finally:
        tracing.reset()


def test_format_table():
    out = S.format_table(S.table(Trace(events())))
    lines = out.splitlines()
    assert lines[0].startswith("| span |") and len(lines) == 2 + 7
    assert lines[2].startswith("| `trainer.iteration` |")
