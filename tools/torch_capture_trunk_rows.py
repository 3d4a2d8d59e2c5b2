#!/usr/bin/env python3
"""chip_smoke.py's phase 8 (the real-capture run) alone, with a closer look
at its checks of the fused trunk kernels (5 and 6) on one fused step's rows.

    python3 tools/torch_capture_trunk_rows.py [--repeat N] [--save-failing]
    python3 tools/torch_capture_trunk_rows.py --rows build/chip_smoke_capture/trunk_rows_*.pt

From a checkout's root, one GPU.  Imports ``chip_smoke`` and
``dgmesh_torch`` from the working directory.  Runs phase 8 N times (1 by
default) in one process.  For every trunk call whose rows the phase holds
to the twins it prints one line:

- the gate's verdict (chip_smoke.trunk_measures: norm ratios over the
  distinct input rows, every group of equal rows the same bits) beside the
  verdict of the same limits on norm ratios over all rows (the gate before
  rows were grouped), and both norm ratios of out and dx;
- the distinct rows, the most common input row and how often it repeats
  (the Gaussian slots that are not alive all sit at the origin), whether
  its output differs from the twin's, and by how much relative to itself;
- (a) kernel 5 launched twice on the rows: the same bits or not;
- (b) how many distinct output bit patterns the copies of the most common
  row have (1 when the kernel is independent of a row's position);
- (c) the twin with float64 sums of the same bf16 products (as
  tests/test_torch_mlp_fused.py::test_twins_summation_order_spread makes
  it) on the distinct rows: the kernel's and the twin's relative error
  against it, on the most common row and in norm over the distinct rows.

``--save-failing`` writes x, wb, bp and g of every trunk call on which
either verdict fails to ``build/chip_smoke_capture/trunk_rows_<run>_<call>.pt``;
``--rows FILE...`` prints the same lines for saved calls without running
the phase.  Ends with one summary line: the runs, the runs and calls that
failed the gate and that failed the all-rows measure, the phase's other
failures.  Exits 1 if the gate or the phase failed, 2 without a GPU.
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.getcwd())


def diagnose(torch, cs, MF, x, wb, bp, got, want):
    """The line's fields beyond the verdicts: (a), (b) and (c)."""
    first, reps = cs.row_groups(torch, x)
    counts = torch.bincount(first, minlength=x.shape[0])
    top = int(counts.argmax())
    copies = first == top
    out = got[0]
    d_top = out[top].double() - want[0][top].double()
    again = MF.trunk_fwd(x, wb, bp)
    twice = torch.equal(again.view(torch.int32), out.view(torch.int32))
    patterns = torch.unique(out[copies].view(torch.int32), dim=0).shape[0]
    layer = MF._layer
    MF._layer = lambda h, w: (h.double() @ w.double()).float()
    try:
        f64 = MF.trunk_fwd_ref(x[reps], wb, bp).double()
    finally:
        MF._layer = layer

    def rel(a, b):
        return float((a.double() - b).norm() / b.norm().clamp_min(1e-30))

    i = int(torch.searchsorted(reps, torch.tensor(top, device=reps.device)))
    return (f"{reps.numel()} distinct rows; the most common row x{int(counts[top])} "
            f"{'differs' if bool(d_top.ne(0).any()) else 'agrees'} "
            f"({float(d_top.norm() / want[0][top].double().norm().clamp_min(1e-30)):.3g} of "
            f"itself); (a) kernel 5 twice {'the same bits' if twice else 'DIFFERENT BITS'}; "
            f"(b) {patterns} output bit pattern(s) over its copies; (c) against float64 "
            f"sums: that row kernel {rel(out[top], f64[i]):.3g} twin "
            f"{rel(want[0][top], f64[i]):.3g}, distinct rows kernel "
            f"{rel(out[reps], f64):.3g} twin {rel(want[0][reps], f64):.3g}")


def check(torch, cs, MF, x, wb, bp, g, what, tally, save=None):
    """One trunk call: both verdicts and the diagnosis, printed; the rows
    saved where either verdict fails and ``save`` names a file."""
    got = [MF.trunk_fwd(x, wb, bp), *MF.trunk_bwd(x, wb, bp, g)]
    want = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    ok, rep, groups = cs.trunk_measures(torch, x, g, got, want)
    placed = all(torch.equal(torch.isnan(a), torch.isnan(b))
                 and torch.equal(torch.isfinite(a), torch.isfinite(b)) for a, b in zip(got, want))
    old_ok = placed and cs.trunk_limits({k: (v[0], v[3]) for k, v in rep.items()})
    tally["gate"] += not ok
    tally["all rows"] += not old_ok
    print(f"# trunk {what} {tuple(x.shape)}: gate {'ok' if ok else 'FAIL'}, all-rows measure "
          f"{'ok' if old_ok else 'FAIL'}; out norm {rep['out'][1]:.3g} (all rows "
          f"{rep['out'][3]:.3g}, limit {cs.TOL_MLP_FWD_NORM}), dx norm {rep['dx'][1]:.3g} "
          f"(all rows {rep['dx'][3]:.3g}); each group the same bits: out "
          f"{groups['out'][1]}, dx {groups['dx'][1]} over {groups['dx'][0]} distinct (x, g); "
          + diagnose(torch, cs, MF, x, wb, bp, got, want), flush=True)
    if save and not (ok and old_ok):
        os.makedirs(os.path.dirname(save), exist_ok=True)
        torch.save({k: v.cpu() for k, v in dict(x=x, wb=wb, bp=bp, g=g).items()}, save)
        print(f"#   saved to {os.path.relpath(save)}", flush=True)
    return ok, rep, groups


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=1, help="runs of phase 8")
    ap.add_argument("--save-failing", action="store_true",
                    help="save the rows of every trunk call that fails either verdict")
    ap.add_argument("--rows", nargs="*", help="saved trunk calls to check instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from dgmesh_torch.ops import cuda_build
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.ops import mlp_fused as MF
    from dgmesh_torch.ops import splat_kernels as SK
    cuda_build.build()
    print(cs.card_line(), flush=True)
    if args.rows is not None:
        tally = {"gate": 0, "all rows": 0}
        for path in sorted(p for pat in args.rows for p in glob.glob(pat)):
            c = torch.load(path)
            x, wb, bp, g = (c[k].cuda() for k in ("x", "wb", "bp", "g"))
            check(torch, cs, MF, x, wb, bp, g, os.path.basename(path), tally)
        print(f"# saved calls: {tally['gate']} failed the gate, {tally['all rows']} the "
              f"all-rows measure", flush=True)
        return 1 if tally["gate"] else 0

    runs = []   # a tally of each run of phase 8

    def compare(torch_, MF_, x, wb, bp, g):
        tally = runs[-1]
        tally["calls"] += 1
        at = f"{len(runs)}_{tally['calls']}"
        save = (os.path.join(cs.CAPTURE_DIR, f"trunk_rows_{at}.pt") if args.save_failing
                else None)
        return check(torch_, cs, MF_, x, wb, bp, g, f"run {len(runs)} call {tally['calls']}",
                     tally, save)

    cs.compare_trunk = compare
    counters = (SK.composite_tiles, SK.composite_bwd, MK.shade_tiles, MK.shade_bwd,
                MF.trunk_fwd, MF.trunk_bwd)
    for _ in range(args.repeat):
        runs.append({"gate": 0, "all rows": 0, "calls": 0})
        failures = []
        cs.capture_phase(torch, torch.device("cuda"), failures, counters, [])
        runs[-1]["other"] = [f for f in failures if "trunk kernels vs twins" not in f]
        print(f"# run {len(runs)}: trunk calls failing the gate {runs[-1]['gate']}, the "
              f"all-rows measure {runs[-1]['all rows']}; phase 8's other failures "
              f"{runs[-1]['other']}", flush=True)
    print(f"# {len(runs)} runs of phase 8: the gate failed in "
          f"{sum(t['gate'] > 0 for t in runs)} runs ({sum(t['gate'] for t in runs)} trunk "
          f"calls), the all-rows measure in {sum(t['all rows'] > 0 for t in runs)} runs "
          f"({sum(t['all rows'] for t in runs)} calls); runs with other failures "
          f"{sum(bool(t['other']) for t in runs)}; {cs.card_line()}", flush=True)
    return 1 if any(t["gate"] or t["other"] for t in runs) else 0

if __name__ == "__main__":
    sys.exit(main())
