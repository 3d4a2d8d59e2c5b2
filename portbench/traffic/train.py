"""Training traffic: the trainer driven through whole units of iterations
from a seeded state, as ``cli/train.py`` drives it (checkpoints aside).

The mix's parameters (``portbench/workloads/<traffic>.json``):
  first   the first iteration; the state has ``first - 1`` steps behind it
  unit    iterations per ``Trainer.train`` call in the window; the window
          starts at the first unit boundary after the three compared steps,
          runs whole units, and stops after the unit in which ``--seconds``
          passed (a unit of 100 holds exactly one anchor or densify
          iteration where the schedule has one every 100); the traced
          run's timed stretch ends at a multiple of it too, so that it
          holds the structural operations the cell's metrics time

Set-up: the views' ground truth, the state, the trainer, its batch cache
(every view, as after a run's first epoch), the three compared iterations
(each its own ``Trainer.train`` call, the window's call), and the rest of
the first unit.  The inputs the plain reference makes in set-up (the
gradient scales that set Adam's moments, and the mesh images a mesh-phase
mix trains against) are timed apart and left out of ``setup_s``.  The
window then runs untraced, each anchor iteration in it timed on its own
between two synchronisations (``anchor_iter_ms``).  With ``--trace 1`` ten
more iterations run under the profiler, then the stretch with the
synchronised timers.  Last,
with the program's state freed, the reference follows the three compared
iterations from the same inputs.
"""

from __future__ import annotations

import contextlib
import math
import random
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness as H
from portbench.counts import work as W
from portbench.inputs import (camera, cameras_extent, gradient_scales, make_views, mesh_gt,
                              optimizer_counts, program_state, raw_state, reference_state,
                              reference_view, render_gt)
from portbench.reference import step as RS
from portbench.spec import build_config, load_program

COMPARED = 3
PROFILED = 10
LOG_EVERY = 100       # cli/train.py's: min(cfg log_every, 100)
ADAM_B1 = 0.9


def camera_index(seed: int, it: int, n: int) -> int:
    """The trainer's seeded camera order: epochs of n iterations, each an
    independent permutation from (seed, epoch)."""
    epoch, pos = divmod(it - 1, n)
    return random.Random((seed << 32) ^ epoch).sample(range(n), n)[pos]


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    """Iteration ``it``'s random stream, from (seed, it) as the trainer makes it."""
    return torch.Generator(device=device).manual_seed(((seed << 32) ^ it) & 0xFFFFFFFFFFFFFFFF)


def leaves(state, which: str):
    """[(name, tensor)] of the program's Gaussian leaves and every net
    parameter: ``params`` the values, ``grads`` the first step's gradients
    as Adam's first moments after one step from zero give them
    (m = (1 - b1) g)."""
    out = []
    if which == "params":
        gp = state.gp
        nets = [dict(n.named_parameters()) for n in state.nets]
    else:
        gp = type(state.g_mu)(*[m / (1.0 - ADAM_B1) for m in state.g_mu])
        nets = [{k: m / (1.0 - ADAM_B1) for (k, _), m in zip(n.named_parameters(), o.mu)}
                for n, o in zip(state.nets, state.net_opt)]
    out += [(f"gp.{k}", v) for k, v in zip(gp._fields, gp)]
    for name, d in zip(state.nets._fields, nets):
        out += [(f"{name}.{k}", v) for k, v in d.items()]
    return [(k, v.detach().to("cpu", copy=True)) for k, v in out]


def ref_leaves(st: RS.State, which: str):
    """``leaves`` of the reference's State."""
    if which == "params":
        gp, nets = st.gp, st.nets
    else:
        gp = {k: m / (1.0 - ADAM_B1) for k, m in st.g_mu.items()}
        nets = {n: {k: m / (1.0 - ADAM_B1) for k, m in w.items()} for n, w in st.net_mu.items()}
    out = [(f"gp.{k}", v) for k, v in gp.items()]
    out += [(f"{n}.{k}", v) for n, w in nets.items() for k, v in w.items()]
    return [(k, v.detach().to("cpu", copy=True)) for k, v in out]


def worst_leaf_gap(prog, ref, keep=None):
    """max over leaves of |‖prog‖ − ‖ref‖| / max(‖ref‖, median leaf ‖ref‖),
    over the leaves in ``keep`` (all when None)."""
    pn = {k: float(v.double().norm()) for k, v in prog}
    rn = {k: float(v.double().norm()) for k, v in ref}
    names = [k for k, _ in ref if keep is None or k in keep]
    med = float(np.median([rn[k] for k in names])) if names else 0.0
    worst, at = 0.0, ""
    for k in names:
        den = max(rn[k], med)
        g = abs(pn[k] - rn[k]) / den if den > 0 else (0.0 if pn[k] == 0 else math.inf)
        if not g <= worst:
            worst, at = g, k
    return worst, at


def moving_leaves(ref_grads):
    """The leaves whose reference gradient reaches a thousandth of the
    median leaf's: the others (inactive nets, a bias under softmax) move
    under Adam by round-off alone."""
    n = {k: float(v.double().norm()) for k, v in ref_grads}
    med = float(np.median(list(n.values())))
    return {k for k, v in n.items() if v >= 1e-3 * med}


def sub(a, b):
    return [(k, x - y) for (k, x), (_, y) in zip(a, b)]


class Program:
    """The program's side: the trainer, driven by whole units."""

    def __init__(self, spec, seed: int, device, P, views, raw, scales):
        conf, mix = spec.config, spec.mix
        self.P, self.device, self.seed = P, device, seed
        self.cfg, self.views = build_config(P, conf), views
        blender = self.cfg.model.is_blender
        scene = SimpleNamespace(
            train_cameras=[camera(P, v, blender) for v in self.views],
            cameras_extent=cameras_extent(self.views), time_interval=1.0 / len(self.views),
            point_cloud=None)
        self.first = mix["first"]
        state = program_state(P, self.cfg, raw, self.first - 1, scales,
                              optimizer_counts(conf["config"], self.first))
        self.p0 = leaves(state, "params")
        self.trainer = P.loop.Trainer(self.cfg, scene, state=state, seed=seed, device=device)
        for cam in scene.train_cameras:
            self.trainer.get_batch(cam)
        self.overflow = 0.0
        self.it = self.first

    def train(self, last: int) -> None:
        """Iterations self.it..last in one ``Trainer.train`` call."""
        self.trainer.train(iterations=last, first_iter=self.it, log_every=LOG_EVERY)
        m = self.trainer.metrics_history[-1]
        self.overflow = max(self.overflow, float(m.get("mesh_overflow", 0.0)))
        self.it = last + 1

    def compared_steps(self):
        losses = []
        for k in range(COMPARED):
            self.train(self.it)
            losses.append(self.trainer.metrics_history[-1]["loss"])
            if k == 0:
                g1 = leaves(self.trainer.state, "grads")
        return losses, g1, leaves(self.trainer.state, "params")


class Reference:
    """The reference's side from the same inputs: its own state from the
    raw tensors, its own cameras, the iteration's random stream."""

    def __init__(self, spec, seed: int, device, first: int, views, raw):
        self.seed, self.device, self.first, self.raw = seed, device, first, raw
        self.conf = spec.config
        self.ctx = RS.Ctx(self.conf["config"], device)
        self.set_views(views)

    def set_views(self, views) -> None:
        self.views = [reference_view(v, len(views), self.ctx.blender, self.device)
                      for v in views]

    def view(self, it: int) -> RS.View:
        return self.views[camera_index(self.seed, it, len(self.views))]

    def state(self, scales=None) -> RS.State:
        c = optimizer_counts(self.conf["config"], self.first)
        return reference_state(self.conf, self.raw, self.first - 1, scales,
                               c if scales is not None else None)

    def scales(self):
        """Each leaf's gradient scale at the state on the first iteration's view."""
        it = self.first
        return gradient_scales(self.ctx, self.state(), self.view(it), it,
                               iteration_generator(self.seed, it, self.device))

    def steps(self, scales):
        """The compared iterations.  Returns (losses, first gradients,
        params before, params after, the largest mesh overflow)."""
        st = self.state(scales)
        p0 = ref_leaves(st, "params")
        losses, g1, overflow = [], None, 0.0
        for k in range(COMPARED):
            it = self.first + k
            st, loss, over = RS.iteration(self.ctx, st, self.view(it), it,
                                          iteration_generator(self.seed, it, self.device))
            losses.append(loss)
            overflow = max(overflow, float(over))
            if k == 0:
                g1 = ref_leaves(st, "grads")
        return losses, g1, p0, ref_leaves(st, "params"), overflow


def training_inputs(spec, seed: int, device):
    """The training views with their ground truth, the raw state, and the
    gradient scales that set the state's Adam moments, made in set-up by
    the benchmark's own code; and the seconds the reference took of it.
    The views' images are the ray caster's; the scales are the reference's
    gradient against them on the first iteration's view.  With the mix's
    ``"gt": "mesh"`` the images are then replaced by the reference's mesh
    render of the initial state, so that a mesh-phase state starts fitted
    to its mask and mesh image while Adam's moments hold the scale of the
    gradients before the fit, as in a run that has trained this far.  The
    reference's memory is freed and the peak reset after, so that the peak
    read is the program's."""
    conf, mix = spec.config, spec.mix
    views = make_views(conf["camera"], conf["n_train_views"], seed)
    render_gt(views, conf["config"]["model"]["white_background"], device)
    raw = raw_state(conf, seed, device)
    H.sync(device)
    t0 = time.perf_counter()
    RS.full_float32()
    ref = Reference(spec, seed, device, mix["first"], views, raw)
    scales = ref.scales()
    if mix.get("gt") == "mesh":
        mesh_gt(ref.ctx, ref.state(), views, mix["first"])
    del ref
    H.clear_program_state()
    H.sync(device)
    ref_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    return views, raw, scales, ref_s


def compare(prog, ref, limits) -> dict:
    """The numbers that decide ``correct``, each beside its limit: those the
    cell's limits name.  The others are printed on standard error as
    readings.  ``first_loss_gap`` is the first step's alone: from the second
    step on the program's own runs of one seed can differ by tenths of a
    percent (its float32 sums are not in a fixed order, and the per-tile
    caps and the mesh turn a rounding into a discrete change).
    ``grad_gap`` is taken over the leaves of more than one number;
    ``scalar_grad_gap`` over the one-number leaves (density_thres, whose
    gradient sums the mask term over the silhouette's pixels, so that a
    pixel flipped by rounding moves it by tens of percent)."""
    (lp, gp, p0p, p3p, ovp), (lr, gr, p0r, p3r, ovr) = prog, ref
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr)]
    tensors = {k for k, v in gr if v.numel() > 1}
    grad_gap, grad_at = worst_leaf_gap(gp, gr, tensors)
    scalar_gap, _ = worst_leaf_gap(gp, gr, {k for k, _ in gr} - tensors)
    keep = moving_leaves(gr)
    change_gap, change_at = worst_leaf_gap(sub(p3p, p0p), sub(p3r, p0r), keep)
    vals = dict(loss_gap=max(gaps), first_loss_gap=gaps[0], grad_gap=grad_gap,
                scalar_grad_gap=scalar_gap, change_gap=change_gap,
                mesh_overflow=max(ovp, ovr))
    H.stderr(f"# compared: losses program {lp} reference {lr}; worst gradient leaf "
             f"{grad_at}, worst change leaf {change_at} ({len(keep)} of {len(gr)} leaves "
             f"move); readings " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    return {k: {"value": float(vals[k]), "limit": float(v)} for k, v in limits.items()}


def work_of(P, cfg, records, counts) -> dict:
    """The needed work of the profiled iterations, per iteration: the nets'
    flops on live rows and valid vertices at their arithmetic's peak, the
    DPSR's FFTs, the mesh raster's pairs, and the kernels' bytes."""
    blender = cfg.model.is_blender
    fused = P.step.mlp_mode(cfg) == "fused"
    trunk_peak = W.PEAK_BF16 if P.step.mlp_mode(cfg) != "f32" else W.PEAK_F32
    n = len(records)
    trunk = other = fft = 0.0
    for flags, alive, verts in records:
        calls = [("deform", alive, False)]
        if not flags.warm:
            calls.append(("deform_back", alive, False))
        if flags.use_normal:
            calls += [("deform_normal", alive, False), ("deform_back_normal", alive, False)]
        if flags.mesh:
            calls += [("deform_back", verts, False), ("appearance", verts, True)]
            fft += 4 * W.fft_flops(cfg.model.grid_res)
        for net, rows, ig in calls:
            t, o = W.net_flops(rows, blender, net, True, ig)
            trunk, other = trunk + t, other + o
    c = {k: counts.get(k, {}) for k in ("composite", "composite_bwd", "shade", "shade_bwd")}
    splat_b = (W.splat_bytes(c["composite"].get("rows", 0), c["composite"].get("pixels", 0),
                             False)
               + W.splat_bytes(c["composite_bwd"].get("rows", 0),
                               c["composite_bwd"].get("pixels", 0), True))
    raster_f = W.raster_ops(c["shade"].get("pairs", 0))
    raster_b = (W.raster_bytes(c["shade"].get("rows", 0), c["shade"].get("pixels", 0), False,
                               True)
                + W.raster_bytes(c["shade_bwd"].get("rows", 0), c["shade_bwd"].get("pixels", 0),
                                 True, True))
    per = lambda x: x / max(n, 1)  # noqa: E731
    return dict(
        iterations=n, fused=fused,
        step_least_s=per(W.least_seconds([(trunk, trunk_peak), (other, trunk_peak),
                                          (fft, W.PEAK_F32), (raster_f, W.PEAK_F32)])),
        trunk_least_s=per(W.least_seconds([(trunk, W.PEAK_BF16)])) if fused else None,
        splat_least_s=per(W.least_seconds([], splat_b)) if splat_b else None,
        raster_least_s=per(W.least_seconds([(raster_f, W.PEAK_F32)], raster_b))
        if raster_b else None)


@contextlib.contextmanager
def anchor_clock(trainer, device, ms: list):
    """Appends to ``ms`` the wall time of each anchor iteration the trainer
    runs, from a synchronisation before it to one after it (what the
    trainer stalls on an anchor); other iterations run as they are."""
    orig = trainer.run_iteration

    def timed(it, draws=None):
        if not trainer.flags_for(it).anchor:
            return orig(it, draws)
        H.sync(device)
        t = time.perf_counter()
        m = orig(it, draws)
        H.sync(device)
        ms.append((time.perf_counter() - t) * 1e3)
        return m
    trainer.run_iteration = timed
    try:
        yield
    finally:
        trainer.run_iteration = orig


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
        tmp_dir: str, control: bool = False) -> dict:
    P = load_program()
    mix = spec.mix
    unit = mix["unit"]
    out = {}
    with contextlib.redirect_stdout(sys.stderr):
        views, raw, scales, ref_s = training_inputs(spec, seed, device)
        prog = Program(spec, seed, device, P, views, raw, scales)
        losses, g1, p3 = prog.compared_steps()
        rest = -(prog.it - 1) % unit          # the rest of the first unit
        if rest:
            prog.train(prog.it - 1 + rest)
        H.sync(device)
        setup_s = time.perf_counter() - t_start - ref_s
        anchor_ms = []
        t0 = time.perf_counter()
        done = 0
        with anchor_clock(prog.trainer, device, anchor_ms):
            while True:
                prog.train(prog.it + unit - 1)
                done += unit
                if time.perf_counter() - t0 >= seconds:
                    break
        H.sync(device)
        window_s = time.perf_counter() - t0
        out["end_to_end"] = dict(setup_s=setup_s, train_iter_ms=window_s * 1e3 / done)
        if anchor_ms:
            out["end_to_end"]["anchor_iter_ms"] = sum(anchor_ms) / len(anchor_ms)
        out["attempted"], out["failed"] = done, 0
        if trace:
            out.update(traced(spec, prog, P, device, tmp_dir, window_s * 1e3 / done))
        out["device"] = H.device_record(spec.cell["chips"], device)
        prog_side = (losses, g1, prog.p0, p3, prog.overflow)
        prog_mode = P.step.mlp_mode(prog.cfg)
        H.stderr(f"# window: {done} iterations in {window_s:.3f} s; anchor iterations "
                 f"{[round(x, 3) for x in anchor_ms]} ms; mesh overflow "
                 f"{prog.overflow}; peak {out['device']['memory_peak_bytes']} bytes; "
                 f"reference's set-up {ref_s:.3f} s")
        del prog
        H.clear_program_state()
        RS.full_float32()
        ref = Reference(spec, seed, device, mix["first"], views, raw)
        ref_side = ref.steps(scales)
        if control:
            with H.lowered(prog_mode):
                low = ref.steps(scales)
            out["control_checks"] = compare(low, ref_side, spec.limits)
            with H.half_batch():
                half = ref.steps(scales)
            out["fault_checks"] = compare(half, ref_side, spec.limits)
    out["checks"] = compare(prog_side, ref_side, spec.limits)
    return out


def traced(spec, prog, P, device, tmp_dir: str, step_ms: float) -> dict:
    """The profiled iterations and the timed stretch after the window."""
    records = []
    trainer = prog.trainer
    orig = trainer.run_iteration

    def recorded(it, draws=None):
        m = orig(it, draws)
        records.append((trainer.flags_for(it), m.get("n_alive"), m.get("mesh_n_verts", 0)))
        return m
    counter = H.Counter()
    sk, rk = P.splat_kernels, P.raster_kernels
    counter.wrap(sk, "composite_tiles", "composite", H.count_rows(9))
    counter.wrap(sk, "composite_bwd", "composite_bwd", H.count_rows(9, True))
    counter.wrap(rk, "shade_tiles", "shade", H.count_rows(9))
    counter.wrap(rk, "shade_bwd", "shade_bwd", H.count_rows(9, True))
    trainer.run_iteration = recorded
    try:
        tr = H.profiled(lambda: prog.train(prog.it + PROFILED - 1), device, tmp_dir)
    finally:
        counter.restore()
        trainer.run_iteration = orig
    recs = [(f, float(a), float(v)) for f, a, v in records]
    work = work_of(P, prog.cfg, recs, counter.totals())
    timers = H.Timers(device)
    timers.wrap(P.step, "apply_updates", "optimizer")
    timers.wrap(P.loop, "anchor_fn", "anchor")
    unit = spec.mix["unit"]
    try:
        prog.train(-(-prog.it // unit) * unit)
    finally:
        timers.restore()
    H.stderr(f"# traced: {tr.window_s:.3f} s profiled, device busy {tr.busy_s:.3f} s; "
             f"timers { {k: len(v) for k, v in timers.ms.items()} }")
    rec = dict(kind="train", trace=tr, work=work, timers=dict(timers.ms), step_ms=step_ms,
               peak_bytes=torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0)
    return dict(record=rec, busy_s=tr.busy_s, window_s=tr.window_s,
                breakdown={"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})
