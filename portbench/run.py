"""The port's benchmark: one cell, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of ``BENCHMARK.json`` named ``--workload`` on the card: its
set-up, a window of ``--seconds``, with ``--trace 1`` the profiled and
timed stretches, then the comparison with the plain reference.  Prints the
compared numbers beside their limits as the last lines on standard error,
and as the last line of standard output one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown`` (traced
runs) and ``checks``.  Exits non-zero, with no result, without a card, or
if any module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the run inside the checkout, at fixed paths; the kernels
# build into the program's own build/kernels/ there
CACHE = os.path.join(ROOT, "build", "portbench-cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also compare the reference at the precision below the "
                        "configuration's with the reference (the control; not part of "
                        "the benchmark's runs)")
    return p.parse_args(argv)


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str, control: bool = False) -> dict:
    """Run one cell on ``device`` and return its result line (a dict)."""
    import tempfile

    from portbench import harness as H
    from portbench.spec import Spec
    spec = Spec(root, workload)
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        out = spec.traffic_module().run(spec, seed, seconds, trace, device, T_START, tmp,
                                             control=control)
    if trace:
        metrics = H.read_metrics(spec, spec.metrics(True), out["record"])
    else:
        # a window with nothing to time reports nothing: a training window
        # with no anchor iteration has no anchor_iter_ms
        e2e = out["end_to_end"]
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in spec.metrics(False) if m["name"] in e2e}
    checks = out["checks"]
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    device_rec = dict(out["device"])
    if trace:
        device_rec.update(busy_s=out["busy_s"], window_s=out["window_s"])
    line = {"correct": bool(correct), "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device_rec}
    if trace:
        line["breakdown"] = out["breakdown"]
    if control:
        line["control_checks"] = out["control_checks"]
        if "fault_checks" in out:
            line["fault_checks"] = out["fault_checks"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness as H
    from portbench.spec import Spec
    chips = Spec(ROOT, args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        H.stderr(f"portbench: the cell needs {chips} CUDA device(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    line = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                    bool(args.control))
    bad = H.forbidden_modules()
    if bad:
        H.stderr(f"portbench: JAX modules were loaded: {', '.join(bad)}")
        return 3
    for k, v in line["checks"].items():
        H.stderr(f"check {k}: {v['value']:.6g} (limit {v['limit']:.6g})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
