"""DG-Mesh's Neural Actor configuration (configs/neural-actor/D2_vlad.yaml) as
the port runs it and as the benchmark runs it (portbench's
``neural-actor-d2vlad-f32``), on the CPU.

- The cameras: the Neural Actor reader's K camera (``orig_transform`` kept
  for the mesh raster) against the Blender-constructor camera the benchmark
  builds for ``is_blender: true``, at a 37x29 frame.  For a centred K with
  fx = fy they project alike; an off-centre K must not.
- The DPSR frame: ``init_state``'s fixed-centre branch (``data_type``
  NeuralActor) against the plain reference's frame at ratio 2.5; the box
  centre must differ.
- One float32 training step at iteration 12,001 (the normal nets on, the
  positions free) on a small Neural-Actor-layout configuration, a 53x44
  frame (a 5-px tile column and a 12-px tile row, as 1285x940 has): the
  port's first loss and every leaf's gradient against
  ``portbench.reference``'s on the same seeded inputs; with the normal nets
  held off in the port (the control) the comparison must fail.  The same
  step under the profiler counts its frame's pixels and tiles.
- ``portbench/metrics/loss_device_ms.py`` on a synthetic trace.

    python -m pytest tests/test_torch_neural_actor.py -q -p no:cacheprovider
"""

import argparse
import json
import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dgmesh_torch import tracing  # noqa: E402
from dgmesh_torch.config import Config, add_config_args, config_from_args  # noqa: E402
from dgmesh_torch.data.readers import read_neural_actor_scene  # noqa: E402
from dgmesh_torch.ops.splat import CameraArrays  # noqa: E402
from dgmesh_torch.train.state import init_state  # noqa: E402
from dgmesh_torch.train.step import make_batch  # noqa: E402
from dgmesh_torch.utils_io import write_png  # noqa: E402
from portbench import inputs as I  # noqa: E402
from portbench.harness import WINDOW_LABEL, Trace  # noqa: E402
from portbench.reference import step as RS  # noqa: E402
from portbench.spec import load_file, load_program  # noqa: E402

torch.set_num_threads(2)

CONF = os.path.join(ROOT, "portbench", "configs", "neural-actor-d2vlad-f32.json")
YAML = os.path.join(ROOT, "configs", "neural-actor", "D2_vlad.yaml")
SEED = 2**31 + 4099
B2CV = np.diag([1.0, -1.0, -1.0, 1.0])     # Blender/OpenGL <-> OpenCV camera axes
FIRST = 12001                              # the mesh-normal mix's first iteration

# The two cameras are built from one pose, the reader's in float64 from the
# JSON and the harness's in float32: their matrices agree to float32
# rounding (a few ulps of entries of size <= ~5, so 1e-5 absolute), their
# projected pixels to 1e-3 px.  An off-centre principal point moves a
# pixel by (cx - W/2) px, ~1.85 px at 0.55 W, far outside both.
TOL_MATRIX = 1e-5
TOL_PIXEL = 1e-3


def na_conf(**camera) -> dict:
    with open(CONF) as f:
        conf = json.load(f)
    conf["camera"].update(camera)
    return conf


def small_conf(normal_net_warmup=None) -> dict:
    """The configuration at a CPU size: grid 32, 512 slots (256 live), a
    53x44 frame, 2 views; every key of the Neural Actor layout kept
    (is_blender, NeuralActor's fixed centre, ratio 2.5, float32 nets)."""
    conf = na_conf(width=53, height=44)
    cfg = conf["config"]
    cfg["model"].update(grid_res=32, sh_degree=1)
    cfg["optimization"]["dpsr_sig"] = 2.0
    if normal_net_warmup is not None:
        cfg["optimization"]["normal_net_warmup"] = normal_net_warmup
    cfg["tpu"].update(max_gaussians=512, max_verts=16384, max_faces=32768,
                      max_gaussians_per_tile=64, max_dup=1 << 12, max_faces_per_tile=1024,
                      max_face_dup=1 << 16)
    conf.update(n_train_views=2, n_live=256)
    return conf


# --- the configuration file ---------------------------------------------------------

def test_config_is_the_published_yaml_but_its_listed_keys():
    """The config as run is D2_vlad.yaml through the port's own loader,
    every width as published, but for the keys ``reduced`` lists; its
    ``yaml`` is the YAML's keys as the file has them."""
    import yaml
    with open(CONF) as f:
        conf = json.load(f)
    with open(YAML) as f:
        assert conf["yaml"] == yaml.safe_load(f)
    p = argparse.ArgumentParser()
    add_config_args(p)
    want = config_from_args(p.parse_args([]), YAML).to_dict()
    got = Config.from_dict(conf["config"]).to_dict()
    assert set(conf["reduced"]) == {"n_train_views", "gaussian_center"}
    assert got["model"].pop("gaussian_center") == [0.02, -0.03, 0.01] == list(I.CENTRE)
    assert want["model"].pop("gaussian_center") == [0.1, 0.8, 0.75]
    assert got == want
    assert (got["model"]["data_type"], got["model"]["is_blender"]) == ("NeuralActor", True)
    assert got["model"]["gaussian_ratio"] == 2.5 and got["model"]["grid_res"] == 288
    assert not got["tpu"]["mlp_bf16"] and not got["tpu"]["mlp_fused"]


# --- the cameras -------------------------------------------------------------------------

def write_na_layout(root, views, white=True):
    """The views as a Neural Actor capture's training split on disk (an
    empty test split): OpenCV c2w, per-frame K, frames under training/ and
    masks under training_mask/Annotations/; read back by the reader."""
    frames = []
    for v in views:
        rel = f"training/cam{v.uid:02d}/0000.png"
        write_png(os.path.join(root, rel), np.full((v.height, v.width, 3), 128, np.uint8))
        write_png(os.path.join(root, f"training_mask/Annotations/cam{v.uid:02d}/0000.png"),
                  np.full((v.height, v.width), 255, np.uint8))
        frames.append(dict(transform_matrix=(v.c2w @ B2CV).tolist(), intrinsic=v.K.tolist(),
                           time=v.fid, file_path=rel))
    for split, fr in (("train", frames), ("test", [])):
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(frames=fr), f)
    return read_neural_actor_scene(str(root), white_background=white).train_cameras


def projections(cam, pts):
    """The splat's pixel coordinates (ndc2Pix of full_proj) and the mesh
    raster's (the GL projection of the mesh pose, y up) of pts (N,3)."""
    b = make_batch(cam, 0.1, np.ones(3, np.float32), "cpu")
    hom = torch.cat([pts, torch.ones_like(pts[:, :1])], -1)
    ph = hom @ b.cam.full_proj.T
    ndc = ph[:, :2] / ph[:, 3:]
    splat = torch.stack([((ndc[:, 0] + 1) * cam.width - 1) * 0.5,
                         ((ndc[:, 1] + 1) * cam.height - 1) * 0.5], -1)
    clip = hom @ (b.mesh_proj @ b.mesh_pose).T
    ndc = clip[:, :2] / clip[:, 3:]
    mesh = torch.stack([(ndc[:, 0] + 1) * 0.5 * cam.width, (1 - ndc[:, 1]) * 0.5 * cam.height],
                       -1)
    return b, splat, mesh


@pytest.mark.parametrize("cx,same", [(0.5, True), (0.55, False)],
                         ids=["centred K", "off-centre K (control)"])
def test_reader_camera_is_the_harness_camera(tmp_path, cx, same):
    """At 37x29, every view's batch matrices and the points' pixels through
    both projections; the control's principal point is off centre."""
    conf = na_conf(width=37, height=29, cx=cx)
    views = I.make_views(conf["camera"], 3, SEED)
    read = write_na_layout(tmp_path, views)
    P = load_program()
    gen = torch.Generator().manual_seed(0)
    pts = I.surface_points(64, gen, "cpu")[0]
    for v, na in zip(views, read):
        hb = I.camera(P, v, blender=True)
        assert (na.width, na.height) == (hb.width, hb.height) == (37, 29)
        bn, sn, mn = projections(na, pts)
        bh, sh, mh = projections(hb, pts)
        close = [torch.allclose(getattr(bn.cam, k), getattr(bh.cam, k), rtol=0, atol=TOL_MATRIX)
                 for k in CameraArrays._fields]
        close += [torch.allclose(bn.mesh_pose, bh.mesh_pose, rtol=0, atol=TOL_MATRIX),
                  torch.allclose(bn.mesh_proj, bh.mesh_proj, rtol=0, atol=TOL_MATRIX),
                  torch.allclose(sn, sh, rtol=0, atol=TOL_PIXEL),
                  torch.allclose(mn, mh, rtol=0, atol=TOL_PIXEL)]
        if same:
            assert all(close), close
        else:
            # the pose is the same; the projections are not
            assert close[0] and close[len(CameraArrays._fields)]
            assert not close[1] and not any(close[-3:]), close
            assert (sn - sh)[:, 0].abs().min() > 1.0


# --- the DPSR frame ----------------------------------------------------------------------

@pytest.mark.parametrize("data_type,same", [("NeuralActor", True), ("", False)],
                         ids=["fixed centre", "box centre (control)"])
def test_dpsr_frame_is_the_reference_frame(data_type, same):
    """``init_state`` fits the DPSR frame of the live points; with data_type
    NeuralActor at the configuration's centre and ratio 2.5, as the plain
    reference does.  The same extremes of the same float32 points give the
    half-width, so the frames agree to one rounding (rtol 1e-6)."""
    conf = small_conf()
    raw = I.raw_state(conf, SEED, "cpu")
    live = raw["alive"]
    cfg = Config.from_dict(conf["config"])
    cfg.model.data_type = data_type
    st = init_state(cfg, raw["gp"]["xyz"][live].numpy(), np.full((int(live.sum()), 3), 0.5,
                                                                  np.float32), device="cpu")
    ref = I.reference_state(conf, raw, FIRST - 1)
    assert cfg.model.gaussian_ratio == 2.5
    close = (torch.allclose(st.gs.gaussian_center, ref.center, rtol=1e-6, atol=0)
             and torch.allclose(st.gs.gaussian_scale, ref.scale, rtol=1e-6, atol=0))
    assert close == same, (st.gs.gaussian_center, ref.center, st.gs.gaussian_scale, ref.scale)
    if same:
        assert torch.equal(ref.center, torch.tensor(conf["config"]["model"]["gaussian_center"]))


# --- one training step -------------------------------------------------------------------

# The port's kernels run their plain twins here and the reference sums in
# other orders (cumsum, einsum): on this seed the first losses agree to
# 6.2e-8 relative and each tensor leaf's gradient to 2.0e-5 of its norm, so
# the limits are 1e-6 and 2e-4.  density_thres's one number sums the mask
# term over the silhouette's pixels, where a pixel that rounding flips moves
# it most: 1.0e-6 here, 1.0e-4 at a 61x45 frame, limit 2e-3.  A leaf the
# reference leaves at zero must be zero.  Holding the normal nets off
# (the control) moves the loss by 3.3e-4 (the cycle loss loses its normal
# term) and leaves their gradients at zero: a gap of 1.
TOL_LOSS = 1e-6
TOL_LEAF = 2e-4
TOL_SCALAR_LEAF = 2e-3


def leaf_gaps(prog, ref):
    out = {}
    for (k, a), (k2, b) in zip(prog, ref):
        assert k == k2
        d, n = float((a - b).double().norm()), float(b.double().norm())
        out[k] = d / n if n > 0 else (0.0 if d == 0 else math.inf)
    return out


@pytest.fixture(scope="module")
def step_runs():
    """The inputs once (views, ground truth, state, Adam's moments), the
    reference's first iteration once, the port's with the normal nets on
    (traced, for its counters) and held off."""
    train = load_file(os.path.join(ROOT, "portbench", "traffic", "train.py"),
                      "na_traffic_train")
    mix = {"kind": "train", "first": FIRST, "unit": 5, "gt": "mesh"}
    spec = SimpleNamespace(config=small_conf(), mix=mix)
    views, raw, scales, _ = train.training_inputs(spec, SEED, "cpu")
    P = load_program()

    def program(conf, traced=False):
        prog = train.Program(SimpleNamespace(config=conf, mix=mix), SEED, "cpu", P, views, raw,
                             scales)
        counts = None
        if traced:
            from torch.profiler import ProfilerActivity, profile
            tracing.reset()
            with profile(activities=[ProfilerActivity.CPU]):
                prog.train(prog.it)
            counts = tracing.counts()
            tracing.reset()
        else:
            prog.train(prog.it)
        m = prog.trainer.metrics_history[-1]
        return SimpleNamespace(loss=m["loss"], grads=train.leaves(prog.trainer.state, "grads"),
                               n_verts=m["mesh_n_verts"], overflow=m["mesh_overflow"],
                               counts=counts, ctx=prog.trainer.ctx)
    ref = train.Reference(spec, SEED, "cpu", FIRST, views, raw)
    RS.full_float32()
    st, loss, over = RS.iteration(ref.ctx, ref.state(scales), ref.view(FIRST), FIRST,
                                  train.iteration_generator(SEED, FIRST, "cpu"))
    assert RS.flags(ref.ctx, FIRST).use_normal and not RS.flags(ref.ctx, FIRST).freeze_pos
    return SimpleNamespace(ref_loss=loss, ref_grads=train.ref_leaves(st, "grads"),
                           ref_overflow=float(over), on=program(spec.config, traced=True),
                           off=program(small_conf(normal_net_warmup=FIRST - 10000 + 1)))


@pytest.mark.parametrize("normal_nets,same", [("on", True), ("off", False)],
                         ids=["normal nets on", "normal nets off (control)"])
def test_float32_step_is_the_reference_step(step_runs, normal_nets, same):
    prog = getattr(step_runs, normal_nets)
    assert prog.n_verts > 0 and prog.overflow == 0 and step_runs.ref_overflow == 0
    loss_gap = abs(prog.loss - step_runs.ref_loss) / abs(step_runs.ref_loss)
    gaps = leaf_gaps(prog.grads, step_runs.ref_grads)
    scalar = {k for k, v in step_runs.ref_grads if v.numel() == 1}
    bad = {k: g for k, g in gaps.items() if g > (TOL_SCALAR_LEAF if k in scalar else TOL_LEAF)}
    if same:
        assert loss_gap <= TOL_LOSS and not bad, (loss_gap, bad)
        # the normal nets train: their gradients are not zero
        assert all(float(v.norm()) > 0 for k, v in prog.grads
                   if k.startswith("deform_normal.trunk"))
    else:
        assert loss_gap > TOL_LOSS
        assert all(k in bad for k, _ in step_runs.ref_grads
                   if k.startswith(("deform_normal.trunk", "deform_back_normal.trunk")))


def test_step_counts_its_pixels_and_tiles(step_runs):
    """53x44 in 16x16 tiles: 4 x 3, the last column 5 px wide and the last
    row 12 px tall."""
    c, sc = step_runs.on.counts, step_runs.on.ctx.splat_cfg
    assert (sc.tiles_x, sc.tiles_y) == (4, 3)
    assert (sc.width - 16 * (sc.tiles_x - 1), sc.height - 16 * (sc.tiles_y - 1)) == (5, 12)
    assert c["image.pixels"] == 53 * 44 and c["splat.tiles"] == 12


# --- the loss_device_ms reader -----------------------------------------------------------

def _x(name, cat, ts, dur, tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)


def loss_trace(with_loss=True, orphan=False):
    """One iteration: a launch in step.forward, two inside loss.image (the
    mesh's and the splat image's), one on the backward thread; each device
    record follows the call that issued it."""
    ev = [_x(WINDOW_LABEL, "user_annotation", 0, 1000),
          _x("trainer.iteration", "user_annotation", 10, 500),
          _x("step.forward", "user_annotation", 20, 200),
          _x("step.backward", "user_annotation", 250, 200)]
    launches = [(40, 10), (110, 20), (160, 30), (300, 40)]
    for ts, dur in launches:
        ev += [_x("cudaLaunchKernel", "cuda_runtime", ts, 2, tid=2 if ts == 300 else 1),
               _x(f"k{ts}", "kernel", ts + 5, dur, tid=7)]
    if with_loss:
        ev += [_x("loss.image", "user_annotation", 100, 20),
               _x("loss.image", "user_annotation", 150, 20)]
    if orphan:
        ev.append(_x("orphan", "kernel", 700, 3, tid=7))
    return dict(kind="train", trace=Trace(ev), work={"iterations": 1}, timers={}, step_ms=1.0)


@pytest.mark.parametrize("case,want", [("spans", 0.050), ("no span", None),
                                       ("no link", None)])
def test_loss_device_ms_reads_the_loss_span(case, want):
    r = load_file(os.path.join(ROOT, "portbench", "metrics", "loss_device_ms.py"), "r_loss")
    rec = loss_trace(with_loss=case != "no span", orphan=case == "no link")
    got = r.read("loss_device_ms.actor", rec)
    assert got == (None if want is None else pytest.approx(want))
    # the benchmark's spans reader keeps its own span list
    from portbench import spans as S
    assert not S.SPAN.match("loss.image")
