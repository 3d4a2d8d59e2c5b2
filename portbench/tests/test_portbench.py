"""CPU tests of the port's benchmark, at a tiny size.

    python -m pytest portbench/tests -q -p no:cacheprovider

A throwaway root holds a copy of the benchmark's files plus a tiny
configuration (grid 32, 512 Gaussian slots, 64x64 views) under its own name;
the cells run on the CPU, where the program's kernels take their plain
twins, so the program and the reference must agree exactly there.  The test
that needs the card skips here (``card`` marker).
"""

from __future__ import annotations

import json
import os
import random
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness as H  # noqa: E402
from portbench.counts import work as W  # noqa: E402
from portbench.inputs import (make_views, program_state, raw_state, reference_state,  # noqa: E402
                              render_gt)
from portbench.reference import step as RS  # noqa: E402
from portbench.run import run_cell  # noqa: E402
from portbench.spec import Spec, build_config, load_program  # noqa: E402

SEED = 2**31 + 77
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def tiny_config(base: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", base + ".json")) as f:
        c = json.load(f)
    cfg = c["config"]
    cfg["model"].update(grid_res=32, sh_degree=1)
    cfg["optimization"]["dpsr_sig"] = 2.0
    cfg["tpu"].update(max_gaussians=512, max_verts=16384, max_faces=32768,
                      max_gaussians_per_tile=64, max_dup=1 << 12, max_faces_per_tile=1024,
                      max_face_dup=1 << 16)
    c["camera"].update(width=64, height=64 if base.startswith("dgmesh") else 48)
    c.update(n_train_views=4, n_live=256)
    return c


def make_root(tmp_path, cells):
    """A throwaway checkout: BENCHMARK.json and portbench/ with the cells
    ``[(name, base config, traffic, mix, limits)]`` added as files only."""
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, base, traffic, mix, limits in cells:
        conf = f"tiny-{base}"
        with open(os.path.join(root, "portbench", "configs", conf + ".json"), "w") as f:
            json.dump(tiny_config(base), f)
        with open(os.path.join(root, "portbench", "workloads", traffic + ".json"), "w") as f:
            json.dump(mix, f)
        with open(os.path.join(root, "portbench", "limits", name + ".json"), "w") as f:
            json.dump(limits, f)
        bench["workloads"].append({"name": name, "config": conf, "traffic": traffic,
                                   "chips": 1, "why": "a throwaway cell of the tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w in m["workloads"] for w in _like(traffic)):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _like(traffic: str):
    return {"tiny_mesh": ["beagle.mesh"], "tiny_render": ["beagle.render"],
            "tiny_fused": ["tail.anchor"]}.get(traffic, [])


MESH = ("tiny.mesh", "dgmesh-beagle-f32", "tiny_mesh",
        {"kind": "train", "first": 11001, "unit": 5, "gt": "mesh"},
        {"loss_gap": 2e-5, "first_loss_gap": 1e-6, "grad_gap": 5e-5, "change_gap": 3e-3,
         "mesh_overflow": 0.0})
RENDER = ("tiny.render", "dgmesh-beagle-f32", "tiny_render",
          {"kind": "render", "views": 3, "step": 25000, "sample": 2},
          {"image_mean": 1e-6, "mesh_image_mean": 1e-6, "mask_share": 0.0,
           "mesh_overflow": 0.0})
FUSED = ("tiny.fused", "nerfies-tail-fused", "tiny_fused",
         {"kind": "train", "first": 16091, "unit": 5},
         {"loss_gap": 2e-5, "grad_gap": 1e-2, "change_gap": 2e-2, "mesh_overflow": 0.0})


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("portbench"), [MESH, RENDER, FUSED])


def test_finds_every_piece_by_name():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        spec = Spec(ROOT, w["name"])
        assert spec.config["name"] == w["config"]
        assert spec.traffic_module().run
        assert set(spec.limits) and all(v >= 0 for v in spec.limits.values())
        for m in spec.metrics(True):
            assert spec.reader(m["name"]).read
        assert spec.metrics(False)[0]["name"] == "setup_s"
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert set(c["reduced"]) == set(conf["reduced"])
        # every key of the source YAML is held, with the source's value
        # unless the key is listed as changed
        cfg = build_config(load_program(), conf)
        for k, v in conf["yaml"].items():
            got = [getattr(getattr(cfg, g), k) for g in ("model", "optimization", "tpu")
                   if hasattr(getattr(cfg, g), k)]
            if got and k not in c["reduced"]:
                assert got[0] == (float(v) if isinstance(got[0], float) else v), k


def test_inputs_are_the_seeds():
    cam = tiny_config("dgmesh-beagle-f32")["camera"]
    a, b = make_views(cam, 5, SEED), make_views(cam, 5, SEED)
    render_gt(a, False, "cpu")
    render_gt(b, False, "cpu")
    assert all((x.image == y.image).all() and x.fid == y.fid for x, y in zip(a, b))
    assert 0 < a[0].mask.mean() < 1
    c = make_views(cam, 5, SEED + 1)
    assert not all((x.c2w == y.c2w).all() for x, y in zip(a, c))
    conf = tiny_config("dgmesh-beagle-f32")
    P = load_program()
    raw = raw_state(conf, SEED, "cpu")
    assert torch.equal(raw["gp"]["xyz"], raw_state(conf, SEED, "cpu")["gp"]["xyz"])
    scales = {k: 1.0 for k in ["gp." + n for n in RS.GP]}
    scales.update({f"{n}.{k}": 1.0 for n, w in raw["nets"].items() for k in w})
    counts = dict.fromkeys(["gaussians", *RS.N.NETS], 3)
    sp = program_state(P, build_config(P, conf), raw, 11000, scales, counts)
    sr = reference_state(conf, raw, 11000, scales, counts)
    # the same tensors on both sides; each side fits its own DPSR frame
    for k, x in zip(sp.gp._fields, sp.gp):
        assert torch.equal(x, sr.gp[k]) and torch.equal(getattr(sp.g_nu, k), sr.g_nu[k]), k
    assert torch.equal(sp.gs.alive, sr.alive)
    assert torch.allclose(sp.gs.gaussian_center, sr.center)
    assert torch.allclose(sp.gs.gaussian_scale, sr.scale)
    for name, net in zip(sp.nets._fields, sp.nets):
        for k, x in net.named_parameters():
            assert torch.equal(x, sr.nets[name][k]), k


def test_whole_units():
    from portbench.spec import load_file
    train = load_file(os.path.join(ROOT, "portbench", "traffic", "train.py"), "t")
    for cell, anchors in (("tail.anchor", 1), ("beagle.mesh", 0)):
        spec = Spec(ROOT, cell)
        ctx = RS.Ctx(spec.config["config"], "cpu")
        mix = spec.mix
        start = mix["first"] + train.COMPARED
        start += -(start - 1) % mix["unit"]
        assert (start - 1) % mix["unit"] == 0
        o = spec.config["config"]["optimization"]
        for u in range(3):
            its = range(start + u * mix["unit"], start + (u + 1) * mix["unit"])
            # a unit of the anchor cell holds exactly one anchor iteration;
            # no cell's window holds a densify iteration
            assert sum(RS.flags(ctx, i).anchor for i in its) == anchors
            assert not any(o["densify_from_iter"] < i < o["densify_until_iter"]
                           and i % o["densification_interval"] == 0 for i in its)
    n = 7
    orders = [train.camera_index(SEED, it, n) for it in range(1, 2 * n + 1)]
    assert sorted(orders[:n]) == list(range(n)) == sorted(orders[n:])
    assert orders == [train.camera_index(SEED, it, n) for it in range(1, 2 * n + 1)]


def test_counts_by_hand():
    assert W.trunk_macs(93) == 256 * 93 + 6 * 256 * 256 + (256 + 93) * 256
    t, o = W.net_flops(10, True, "deform", False, False)
    assert t == 10 * 2 * W.trunk_macs(93)
    assert o == 10 * 2 * (256 * 13 + 13 * 256 + 256 * 30)
    t3, _ = W.net_flops(10, True, "deform", True, False)
    assert t3 == 3 * t - 10 * 2 * 256 * 93
    t3i, _ = W.net_flops(10, False, "appearance", True, True)
    assert t3i == 3 * 10 * 2 * W.trunk_macs(84)
    assert W.fft_flops(4) == 2.5 * 64 * 6
    attrs = torch.zeros(3, 5, 16)
    attrs[0, :2, 9] = 1
    attrs[2, 0, 9] = 1
    c = H.count_rows(9)(attrs, 2, 16, 16)
    assert int(c["rows"]) == 3 and c["pixels"] == 3 * 256 and int(c["pairs"]) == 3 * 256
    assert W.splat_bytes(3, 768, False) == 3 * 9 * 4 + 768 * 16
    assert W.least_seconds([(67e12, W.PEAK_F32)], 0.0) == 1.0
    assert W.least_seconds([], 3.35e12) == 1.0


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "dgmesh_tpux", type(sys)("dgmesh_tpux"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", type(sys)("jaxtyping_like"))
    assert "dgmesh_tpux" not in H.forbidden_modules()
    assert "jaxtyping_like" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", type(sys)("jax.numpy"))
    assert "jax.numpy" in H.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    """The reference's sources import neither the program nor JAX."""
    import ast
    d = os.path.join(ROOT, "portbench", "reference")
    for f in sorted(os.listdir(d)):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(d, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in H.FORBIDDEN + ("dgmesh_torch",), (f, n)


def test_mesh_cell_agrees_with_reference(root):
    line = run_cell(root, "tiny.mesh", SEED, 0.0, False, "cpu")
    assert list(line)[:5] == list(KEYS) and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["attempted"] == 5 and line["failed"] == 0
    assert set(line["metrics"]) == {"setup_s", "train_iter_ms"}


def test_render_cell_with_a_new_metric(root):
    """A throwaway cell and a throwaway per-layer metric, added as files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "views_per_s.render", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "render entry",
                               "moves": "render_ms", "workloads": ["tiny.render"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    with open(os.path.join(root, "portbench", "metrics", "views_per_s.py"), "w") as f:
        f.write("def read(name, rec):\n    return 1e3 / rec['step_ms']\n")
    line = run_cell(root, "tiny.render", SEED, 0.0, True, "cpu")
    assert line["correct"], line["checks"]
    assert line["metrics"]["views_per_s.render"]["value"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def _break(monkeypatch, fault: str):
    P = load_program()
    if fault == "state unchanged":
        orig = P.loop.run_iteration

        def stuck(ctx, state, *a, **kw):
            _, m = orig(ctx, state, *a, **kw)
            return state, m
        monkeypatch.setattr(P.loop, "run_iteration", stuck)
    elif fault == "half the batch":
        orig = P.step.L.image_loss

        def half(img, gt, lam):
            h = img.shape[-2] // 2
            return orig(img[..., :h, :], gt[..., :h, :], lam)
        monkeypatch.setattr(P.step.L, "image_loss", half)
    elif fault == "answer altered":
        orig = P.testing.render_frame

        def altered(*a, **kw):
            out = dict(orig(*a, **kw))
            out["render"] = out["render"].clone()
            out["render"][0, 3, 5] += 0.5
            return out
        monkeypatch.setattr(P.testing, "render_frame", altered)


@pytest.mark.parametrize("fault,cell", [("state unchanged", "tiny.mesh"),
                                        ("half the batch", "tiny.mesh"),
                                        ("answer altered", "tiny.render")])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault, cell):
    _break(monkeypatch, fault)
    line = run_cell(root, cell, SEED, 0.0, False, "cpu")
    assert not line["correct"], (fault, line["checks"])


def test_the_lower_precision_control_fails(root):
    """The fused configuration's control: the reference with float8 trunk
    products, held to the reference, fails its limits; the program (its
    kernels' twins here) passes them."""
    line = run_cell(root, "tiny.fused", SEED, 0.0, False, "cpu", control=True)
    assert line["correct"], line["checks"]
    # the window (16096-16100) ends on an anchor iteration, timed on its own
    assert set(line["metrics"]) == {"setup_s", "anchor_iter_ms"}
    assert any(v["value"] > v["limit"] for v in line["control_checks"].values())


@pytest.mark.card
def test_the_tf32_control_fails_on_the_card():
    """The float32 configuration's control, TF32 products, exists only on the
    card; run there by ``python3 portbench/run.py --control 1``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 is a property of its matrix units")
    line = run_cell(ROOT, "beagle.mesh", random.randrange(2**31), 1.0, False, "cuda",
                    control=True)
    assert any(v["value"] > v["limit"] for v in line["control_checks"].values())
