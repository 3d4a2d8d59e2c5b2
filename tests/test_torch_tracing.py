"""The program's spans and counters (dgmesh_torch/tracing.py), on the CPU.

A miniature state (64², grid 32, 512 Gaussian slots, 256 of them live on a
sphere with outward normals) trained by the port's Trainer on one view:
a plain mesh-phase iteration, then a fused-net stretch whose iterations
open the mesh phase with the normal init and an anchor, and densify.  Each
runs with the profiler off (``record_function`` made to fail, every count
spied on) and on (torch.profiler on the CPU, its Chrome trace read back):
the spans each path runs appear and nest, the counters equal the counts by
hand, and the loss and every state leaf are the same bits either way.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch import tracing  # noqa: E402
from dgmesh_torch.cameras import camera_from_c2w_blender  # noqa: E402
from dgmesh_torch.config import Config  # noqa: E402
from dgmesh_torch.eval.testing import render_frame  # noqa: E402
from dgmesh_torch.train.loop import Trainer  # noqa: E402
from dgmesh_torch.train.state import init_state  # noqa: E402
from dgmesh_torch.train.step import make_batch  # noqa: E402

torch.set_num_threads(1)

IMG, SLOTS, LIVE = 64, 512, 256
NETS = ("deform", "deform_normal", "deform_back", "deform_back_normal", "appearance")
GAUSSIAN_NETS = ("deform", "deform_normal", "deform_back", "deform_back_normal")
STEP_SPANS = {"trainer.iteration", "step.forward", "step.backward", "step.sanitize",
              "step.optimizer", "splat.preprocess", "splat.binning", "splat.composite",
              "splat.composite_bwd", "dpsr", "mesh.marching_tets", "raster.rasterize",
              "raster.shade", "raster.shade_bwd", "loss.image", "trainer.log"} | {
                  f"nets.{n}" for n in NETS}
RENDER_SPANS = {"render.frame", "nets.deform", "nets.deform_normal", "nets.deform_back",
                "nets.appearance", "splat.preprocess", "splat.binning", "splat.composite",
                "dpsr", "mesh.marching_tets", "raster.rasterize", "raster.shade"}


def tiny_cfg(fused: bool = False, **opt) -> Config:
    cfg = Config()
    cfg.model.is_blender = True
    cfg.model.grid_res = 32
    cfg.model.sh_degree = 1
    o = cfg.optimization
    o.dpsr_sig = 2.0
    sched = dict(warm_up=0, dpsr_iter=1, normal_warm_up=0, normal_net_warmup=0,
                 densify_until_iter=0, anchor_iter=10 ** 6)
    for k, v in {**sched, **opt}.items():
        setattr(o, k, v)
    t = cfg.tpu
    t.max_gaussians, t.max_verts, t.max_faces = SLOTS, 16384, 32768
    t.max_gaussians_per_tile, t.max_dup = 64, 1 << 12
    t.max_faces_per_tile, t.max_face_dup = 32, 1 << 16
    t.occ_res, t.mlp_bf16, t.mlp_fused = 16, fused, fused
    return cfg


def sphere_state(cfg):
    rng = np.random.default_rng(0)
    d = rng.normal(size=(LIVE, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    st = init_state(cfg, (0.4 * d).astype(np.float32), rng.random((LIVE, 3)).astype(np.float32),
                    seed=0, device="cpu")
    normal = torch.zeros_like(st.gp.normal)
    normal[:LIVE] = torch.as_tensor(d, dtype=torch.float32)
    return st._replace(gp=st.gp._replace(normal=normal * st.gs.alive[:, None]))


def view(fid: float = 0.3):
    rng = np.random.default_rng(1)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    return camera_from_c2w_blender(0, c2w, 0.9, IMG, IMG, fid,
                                   image=rng.random((IMG, IMG, 3)).astype(np.float32),
                                   alpha_mask=np.ones((IMG, IMG, 1), np.float32))


def trainer(cfg, state, step: int) -> Trainer:
    scene = SimpleNamespace(train_cameras=[view()], cameras_extent=1.0, time_interval=0.05,
                            point_cloud=None)
    state = state._replace(step=torch.tensor(step, dtype=torch.int32))
    return Trainer(cfg, scene, state=state, seed=3, device="cpu")


def leaves(state):
    out = {f"gp.{k}": v for k, v in zip(state.gp._fields, state.gp)}
    out.update({f"gs.{k}": v for k, v in zip(state.gs._fields, state.gs)})
    out.update({f"g_mu.{k}": v for k, v in zip(state.g_mu._fields, state.g_mu)})
    out.update({f"g_nu.{k}": v for k, v in zip(state.g_nu._fields, state.g_nu)})
    for name, net, opt in zip(state.nets._fields, state.nets, state.net_opt):
        out.update({f"{name}.{k}": v for k, v in net.named_parameters()})
        out.update({f"{name}.mu{i}": v for i, v in enumerate(opt.mu)})
        out.update({f"{name}.nu{i}": v for i, v in enumerate(opt.nu)})
        out[f"{name}.count"] = opt.count
    out.update(g_count=state.g_count, step=state.step)
    return out


def untraced(fn, monkeypatch):
    """fn() with record_function made to fail; returns (its result, the
    values given to tracing.count)."""
    def boom(self):
        raise AssertionError("a record_function was entered with tracing off")
    seen = []
    count = tracing.count

    def spy(name, value):
        seen.append((name, value))
        return count(name, value)
    with monkeypatch.context() as m:
        m.setattr(torch.autograd.profiler.record_function, "__enter__", boom)
        m.setattr(tracing, "count", spy)
        return fn(), seen


def traced(fn, tmp_path):
    """fn() under torch.profiler on the CPU; returns (its result, the
    program's spans as [(name, ts, end, tid)], the counters)."""
    from torch.profiler import ProfilerActivity, profile
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = ("trainer.", "render.", "step.", "anchor.", "nets.", "splat.", "mesh.", "raster.",
             "loss.")
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
             if e.get("ph") == "X" and e.get("cat") in ("user_annotation", "cpu_op")
             and (e["name"].startswith(names) or e["name"] == "dpsr")]
    c = tracing.counts()
    tracing.reset()
    return out, spans, c


def inside(spans, name, outer):
    """Every span ``name`` lies inside some span ``outer``'s interval."""
    outs = [(a, b) for n, a, b, _ in spans if n == outer]
    return all(any(a <= s and e <= b for a, b in outs) for n, s, e, _ in spans if n == name)


def same_bits(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One mesh-phase iteration (6) and one render, off then on."""
    cfg = tiny_cfg()
    state = sphere_state(cfg)
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("tracing")

    def iteration():
        tr = trainer(cfg, state, 5)
        tr.train(iterations=6, first_iter=6, log_every=100)
        return tr

    def render():
        return render_frame(tr_off.ctx, state, make_batch(view(0.6), 0.05,
                                                          np.zeros(3, np.float32), "cpu"), 1)
    tracing.reset()
    (tr_off, seen_it) = untraced(iteration, mp)
    (img_off, seen_r) = untraced(render, mp)
    off_counts = tracing.counts()
    tr_on, spans_it, counts_it = traced(iteration, tmp)
    img_on, spans_r, counts_r = traced(render, tmp)
    mp.undo()
    return SimpleNamespace(tr_off=tr_off, tr_on=tr_on, seen=seen_it + seen_r,
                           off_counts=off_counts, spans_it=spans_it, counts_it=counts_it,
                           img_off=img_off, img_on=img_on, spans_r=spans_r, counts_r=counts_r,
                           alive=int(state.gs.alive.sum()))


def test_off_enters_no_range_and_counts_nothing(mesh_runs):
    """With no profiler: no record_function entered (the runs would have
    raised), no counter kept, no tensor handed to a count (the live-row
    sums are not computed)."""
    assert mesh_runs.seen and mesh_runs.off_counts == {} and tracing._device == {}
    assert not any(isinstance(v, torch.Tensor) or callable(v) for _, v in mesh_runs.seen)


def test_iteration_emits_its_spans_nested(mesh_runs):
    spans = mesh_runs.spans_it
    assert {n for n, *_ in spans} == STEP_SPANS
    assert sum(n == "trainer.iteration" for n, *_ in spans) == 1
    # the splat image's losses and the mesh's
    assert sum(n == "loss.image" for n, *_ in spans) == 2
    for n in STEP_SPANS:
        if (n.startswith(("splat.", "nets.", "raster.", "dpsr", "mesh.", "loss."))
                and "_bwd" not in n):
            assert inside(spans, n, "step.forward"), n
    for n in ("splat.composite_bwd", "raster.shade_bwd"):
        assert inside(spans, n, "step.backward"), n
    for n in STEP_SPANS - {"trainer.iteration", "trainer.log"}:
        assert inside(spans, n, "trainer.iteration"), n
    assert not inside(spans, "trainer.log", "trainer.iteration")


def test_render_emits_its_spans_nested(mesh_runs):
    spans = mesh_runs.spans_r
    assert {n for n, *_ in spans} == RENDER_SPANS
    for n in RENDER_SPANS - {"render.frame"}:
        assert inside(spans, n, "render.frame"), n


def test_iteration_counts_by_hand(mesh_runs):
    """Each Gaussian net call runs every slot and counts the live ones; the
    vertex calls (deform_back, appearance) run the valid vertices only; the
    step counts its frame's pixels and 16x16 tiles."""
    c, v = mesh_runs.counts_it, int(mesh_runs.tr_on.metrics_history[-1]["mesh_n_verts"])
    assert v > 0
    rows = {n: SLOTS for n in GAUSSIAN_NETS}
    rows["deform_back"] += v
    rows["appearance"] = v
    live = {n: mesh_runs.alive for n in GAUSSIAN_NETS}
    live["deform_back"] += v
    live["appearance"] = v
    assert c == {**{f"nets.rows.{n}": k for n, k in rows.items()},
                 **{f"nets.live_rows.{n}": k for n, k in live.items()},
                 "image.pixels": IMG * IMG, "splat.tiles": (IMG // 16) ** 2}
    assert mesh_runs.alive == LIVE


def test_render_counts_by_hand(mesh_runs):
    c, v = mesh_runs.counts_r, int(mesh_runs.img_on["n_verts"])
    assert c == {"nets.rows.deform": SLOTS, "nets.rows.deform_normal": SLOTS,
                 "nets.rows.deform_back": v, "nets.rows.appearance": v,
                 "nets.live_rows.deform": LIVE, "nets.live_rows.deform_normal": LIVE,
                 "nets.live_rows.deform_back": v, "nets.live_rows.appearance": v}


def test_iteration_same_bits_either_way(mesh_runs):
    a, b = mesh_runs.tr_off, mesh_runs.tr_on
    clock = "iters_per_sec"
    assert ({k: v for k, v in a.metrics_history[-1].items() if k != clock}
            == {k: v for k, v in b.metrics_history[-1].items() if k != clock})
    same_bits(leaves(a.state), leaves(b.state))


def test_render_same_bits_either_way(mesh_runs):
    a, b = mesh_runs.img_off, mesh_runs.img_on
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def structural_runs(tmp_path_factory):
    """Fused nets: iteration 2 opens the mesh phase (normal init) and is an
    anchor iteration; 3 densifies and resets the opacities; off, then on."""
    cfg = tiny_cfg(fused=True, dpsr_iter=2, anchor_iter=1, anchor_interval=2,
                   densify_from_iter=1, densify_until_iter=4, densification_interval=3,
                   opacity_reset_interval=3)
    cfg.optimization.anchor_n_1_bs, cfg.optimization.anchor_0_1_bs = 16, 32
    state = sphere_state(cfg)
    mp = pytest.MonkeyPatch()

    def run():
        tr = trainer(cfg, state, 1)
        tr.train(iterations=3, first_iter=2, log_every=100)
        return tr
    off, _ = untraced(run, mp)
    on, spans, counts = traced(run, tmp_path_factory.mktemp("tracing_s"))
    mp.undo()
    return SimpleNamespace(off=off, on=on, spans=spans, counts=counts, cfg=cfg)


def test_structural_spans_nested(structural_runs):
    """The normal init, the anchor (its kNN inside it), densify and the
    opacity reset, and the fused trunk's backward on the autograd side."""
    spans = structural_runs.spans
    names = {n for n, *_ in spans}
    assert STEP_SPANS | {"step.normal_init", "step.anchor", "anchor.knn", "step.densify",
                         "nets.trunk_bwd"} == names
    assert sum(n == "step.densify" for n, *_ in spans) == 2
    assert inside(spans, "anchor.knn", "step.anchor")
    assert inside(spans, "nets.trunk_bwd", "step.backward")
    for n in names - {"trainer.iteration", "trainer.log"}:
        assert inside(spans, n, "trainer.iteration"), n


def test_structural_counts_cover_every_call(structural_runs):
    """Every net's rows are counted with its live rows, never more live than
    run; the normal init's and the anchor's Gaussian calls add a slot count
    each to deform's (two mesh iterations, the anchor's f32 deform and the
    anchor step's own, the normal init's)."""
    c = structural_runs.counts
    for n in NETS:
        assert 0 < c[f"nets.live_rows.{n}"] <= c[f"nets.rows.{n}"], n
    assert c["nets.rows.deform"] == 5 * SLOTS
    assert c["nets.rows.deform_normal"] == 3 * SLOTS


def test_structural_same_bits_either_way(structural_runs):
    a, b = structural_runs.off, structural_runs.on
    assert [m["loss"] for m in a.metrics_history] == [m["loss"] for m in b.metrics_history]
    same_bits(leaves(a.state), leaves(b.state))


def test_span_decorator_looks_at_each_call(tmp_path):
    """A function decorated while no profiler records is spanned in a later
    profiled call, and a decorated method keeps its name and result."""
    @tracing.span("step.probe")
    def probe(x):
        return x + 1
    assert probe.__name__ == "probe" and probe(1) == 2
    out, spans, _ = traced(lambda: probe(2), tmp_path)
    assert out == 3 and [s[0] for s in spans] == ["step.probe"]
    with tracing.span("step.probe") as s:
        assert s is tracing.span("step.probe")      # one shared null context


def test_counts_sum_host_and_device_values(tmp_path):
    """Host ints and 0-d tensors (kept on their device) sum at the read; a
    callable is called only while recording; reset clears."""
    calls = []

    def value():
        calls.append(1)
        return torch.tensor(4)
    tracing.count("x", value)
    assert not calls and tracing.counts() == {}

    def body():
        tracing.count("x", 3)
        tracing.count("x", torch.tensor(5))
        tracing.count("x", value)
        return tracing.counts()
    from torch.profiler import ProfilerActivity, profile
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = body()
    assert got == {"x": 12} and calls == [1] and tracing.counts() == {"x": 12}
    tracing.reset()
    assert tracing.counts() == {} and not tracing.active()


def test_knn_pairs_counted_while_recording(tmp_path):
    """``knn.pairs`` adds each call's queries times its valid refs while a
    profiler records (k = 1, the kernel's calls on the card, and the twin's
    k = 3 self-search alike), and nothing when none records."""
    from dgmesh_torch.ops.knn import knn, mean_knn_dist2
    rng = np.random.default_rng(9)
    q = torch.as_tensor(rng.random((60, 3)), dtype=torch.float32)
    refs = torch.as_tensor(rng.random((90, 3)), dtype=torch.float32)
    valid = torch.as_tensor(rng.random(90) < 0.6)

    def body():
        knn(q, refs, 1, ref_valid=valid)
        return mean_knn_dist2(refs, valid, k=3)
    tracing.reset()
    off = body()
    assert tracing.counts() == {}
    on, _, counts = traced(body, tmp_path)
    n = int(valid.sum())
    assert counts == {"knn.pairs": 60 * n + 90 * n} and torch.equal(off, on)
