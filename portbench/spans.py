"""The program's spans read from a profiled sub-window (``harness.Trace``).

``dgmesh_torch`` names its stages with ``record_function`` ranges while a
profiler records (``dgmesh_torch/tracing.py``): they arrive in the Trace's
host events beside the CUDA runtime and driver calls, on the same clock.
Each runtime call is put down to the innermost span, on any thread, whose
interval holds the call's start: the autograd engine's thread runs the
backward while the main thread waits in ``step.backward``, so a kernel it
launches goes to a backward span of its own (``splat.composite_bwd``) or
else to ``step.backward``.

A device record is linked to the runtime call that issued it by order: the
program issues all its work on one stream, which runs it in the order
issued, and the sub-window starts and ends on a synchronisation, so the
n-th call that puts a kernel, copy or memset on the device issued the n-th
device record of the window.  The link is taken only where the counts and
the kinds of the two lists agree (a launch with a kernel, a memcpy call with
a copy, a memset call with a memset); else no device time is attributed.

    python3 -m portbench.spans TRACE.json    # the table of a Chrome trace

reads a trace written by ``torch.profiler`` (``cli/train.py
--profile_iters N`` writes one with the program's spans); it needs the
trace to hold one ``portbench.profiled`` range, or it takes the whole trace.
"""

from __future__ import annotations

import bisect
import re
import weakref
from collections import defaultdict
from typing import Dict, List, Optional

SPAN = re.compile(r"^(?:(?:trainer|render|step|anchor|nets|splat|mesh|raster)\.[a-z_.]+|dpsr)$")
ROOTS = ("trainer.iteration", "trainer.log", "render.frame")
ITERATION = {"train": "trainer.iteration", "render": "render.frame"}
CALL = re.compile(r"^cu(?:da)?[A-Z]")
LAUNCH = re.compile(r"^(?:cudaLaunchKernel(?:ExC)?|cuLaunchKernel(?:Ex)?)(?:_v\d+)?$")
SYNC = re.compile(r"^(?:cudaStreamSynchronize|cudaDeviceSynchronize|cudaEventSynchronize"
                  r"|cudaMemcpy)(?:_v\d+)?$")
ISSUES = re.compile(r"^cu(?:da)?(?:Launch(?:Cooperative)?Kernel|Memcpy|Memset)")

_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _kind(call: str) -> str:
    return "memcpy" if "Memcpy" in call else "memset" if "Memset" in call else "kernel"


def _record_kind(name: str) -> str:
    return "memcpy" if name.startswith("Memcpy") else (
        "memset" if name.startswith("Memset") else "kernel")


class Spans:
    """The spans of one Trace, the runtime calls each holds innermost, and
    the device records those calls issued."""

    def __init__(self, trace):
        self.trace = trace
        spans = sorted(((n, ts, dur) for n, ts, dur in trace.host if SPAN.match(n)),
                       key=lambda s: (s[1], -s[2]))
        calls = sorted(((n, ts, dur) for n, ts, dur in trace.host if CALL.match(n)),
                       key=lambda c: c[1])
        self.spans, self.calls = spans, calls
        self.parent: List[int] = [-1] * len(spans)
        self.owner: List[int] = [-1] * len(calls)      # innermost span of each call
        active: List[int] = []
        i = j = 0
        while i < len(spans) or j < len(calls):
            span_next = j >= len(calls) or (i < len(spans) and spans[i][1] <= calls[j][1])
            t = spans[i][1] if span_next else calls[j][1]
            active = [k for k in active if spans[k][1] + spans[k][2] >= t]
            if span_next:
                end = t + spans[i][2]
                outer = [k for k in active if spans[k][1] + spans[k][2] >= end]
                self.parent[i] = min(outer, key=lambda k: spans[k][2]) if outer else -1
                active.append(i)
                i += 1
            else:
                self.owner[j] = min(active, key=lambda k: spans[k][2]) if active else -1
                j += 1
        self.issued = self._link()

    def _link(self) -> Optional[List[List[float]]]:
        """Device seconds issued by each call (by the order link), or None
        where the link does not hold."""
        issuers = [j for j, (n, _, _) in enumerate(self.calls) if ISSUES.match(n)]
        records = sorted(self.trace.device, key=lambda r: r[1])
        if len(issuers) != len(records):
            return None
        out: List[List[float]] = [[] for _ in self.calls]
        for j, (name, _, dur) in zip(issuers, records):
            if _kind(self.calls[j][0]) != _record_kind(name):
                return None
            out[j].append(dur * 1e-6)
        return out

    def roots(self):
        """[(ts, end)] of the root spans."""
        return [(ts, ts + dur) for n, ts, dur in self.spans if n in ROOTS]

    def count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.spans if n == name)

    def calls_in_roots(self, rx) -> int:
        """Runtime calls matching ``rx`` that start inside a root span."""
        roots = self.roots()
        return sum(1 for n, ts, _ in self.calls
                   if rx.match(n) and any(a <= ts <= b for a, b in roots))

    def device_seconds(self, name: str) -> Optional[float]:
        """Device seconds of the records issued by calls whose innermost span
        is named ``name``; None where the link does not hold."""
        if self.issued is None:
            return None
        return sum(sum(self.issued[j]) for j, k in enumerate(self.owner)
                   if k >= 0 and self.spans[k][0] == name)

    def _idle_gaps(self):
        tr, gaps, last = self.trace, [], self.trace.t0
        for a, b in tr.busy:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        if tr.t1 > last:
            gaps.append((last, tr.t1))
        return gaps

    def table(self) -> Dict[str, dict]:
        """Per span name: ``calls``; ``host_ms`` (its intervals summed);
        ``self_ms`` (less the part its child spans cover); ``device_ms`` (the
        device records of the calls it holds innermost; None where the link
        does not hold); ``launches`` and ``syncs`` (the calls it holds
        innermost); ``idle_ms`` (the device's idle time inside its
        intervals)."""
        children: Dict[int, List[int]] = defaultdict(list)
        for k, p in enumerate(self.parent):
            if p >= 0:
                children[p].append(k)
        gaps = self._idle_gaps()
        starts = [a for a, _ in gaps]
        rows: Dict[str, dict] = {}
        for k, (name, ts, dur) in enumerate(self.spans):
            r = rows.setdefault(name, dict(calls=0, host_ms=0.0, self_ms=0.0,
                                           device_ms=None if self.issued is None else 0.0,
                                           launches=0, syncs=0, idle_ms=0.0))
            end = ts + dur
            r["calls"] += 1
            r["host_ms"] += dur * 1e-3
            r["self_ms"] += (dur - _covered(
                [(max(ts, self.spans[c][1]), min(end, self.spans[c][1] + self.spans[c][2]))
                 for c in children[k]])) * 1e-3
            g = max(0, bisect.bisect_right(starts, ts) - 1)
            while g < len(gaps) and gaps[g][0] < end:
                r["idle_ms"] += max(0.0, min(end, gaps[g][1]) - max(ts, gaps[g][0])) * 1e-3
                g += 1
        for j, k in enumerate(self.owner):
            if k < 0:
                continue
            r = rows[self.spans[k][0]]
            n = self.calls[j][0]
            r["launches"] += bool(LAUNCH.match(n))
            r["syncs"] += bool(SYNC.match(n))
            if self.issued is not None:
                r["device_ms"] += sum(self.issued[j]) * 1e3
        return rows


def _covered(iv) -> float:
    """The length of the union of intervals."""
    tot, last = 0.0, None
    for a, b in sorted(iv):
        if b <= a:
            continue
        if last is None or a > last:
            tot += b - a
            last = b
        elif b > last:
            tot += b - last
            last = b
    return tot


def of(trace) -> Spans:
    """The Spans of ``trace``, made once."""
    s = _CACHE.get(trace)
    if s is None:
        s = _CACHE[trace] = Spans(trace)
    return s


def table(trace) -> Dict[str, dict]:
    return of(trace).table()


def iterations(rec: dict) -> int:
    """The profiled iterations (views) of a run's record, by their root
    spans: 0 where the program has no spans."""
    return of(rec["trace"]).count(ITERATION[rec["kind"]])


def per_iteration_calls(rec: dict, rx) -> Optional[float]:
    """Runtime calls matching ``rx`` inside the root spans per profiled
    iteration (view); None where the program has no spans."""
    n = iterations(rec)
    return of(rec["trace"]).calls_in_roots(rx) / n if n else None


def format_table(rows: Dict[str, dict], per: int = 1) -> str:
    """A Markdown table of ``rows``, each number over ``per`` iterations,
    by host time."""
    out = ["| span | calls | host ms | self ms | device ms | launches | syncs | idle ms |",
           "|---|---|---|---|---|---|---|---|"]
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"]):
        dev = "—" if r["device_ms"] is None else f"{r['device_ms'] / per:.3f}"
        out.append(f"| `{name}` | {r['calls'] / per:g} | {r['host_ms'] / per:.3f} | "
                   f"{r['self_ms'] / per:.3f} | {dev} | {r['launches'] / per:g} | "
                   f"{r['syncs'] / per:g} | {r['idle_ms'] / per:.3f} |")
    return "\n".join(out)


def main(argv=None) -> int:
    import argparse
    import json

    from portbench.harness import WINDOW_LABEL, Trace
    p = argparse.ArgumentParser(description="the program's spans in a Chrome trace")
    p.add_argument("trace")
    p.add_argument("--per", type=int, default=1, help="divide by this many iterations")
    a = p.parse_args(argv)
    with open(a.trace) as f:
        events = json.load(f)["traceEvents"]
    if not any(e.get("name") == WINDOW_LABEL for e in events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        t0 = min(e["ts"] for e in xs)
        t1 = max(e["ts"] + e["dur"] for e in xs)
        events = events + [dict(name=WINDOW_LABEL, ph="X", cat="user_annotation", ts=t0,
                                dur=t1 - t0)]
    print(format_table(table(Trace(events)), a.per))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
