"""The port's CLIs on the CPU, on a generated dataset.

``cli.train.main`` with ``device="cpu"`` trains 6 iterations at 64² (grid
32, 512 Gaussian slots): warm-up, a densify iteration, the normal init at
iteration 4 and mesh iterations; it writes the config, the log, the
checkpoints, the test results and (``--export_meshes 3``) the mesh
sequence.  ``cli.render_test`` and ``cli.render_trajectory`` read the run
back; ``cli.mesh_evaluation`` holds the exported meshes to the dataset's
three GT meshes, against JAX's CLI on the same files.  The port's trainer
itself is held to JAX's in test_torch_trainer.py.
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch.cli import evaluate as cli_eval  # noqa: E402
from dgmesh_torch.cli import mesh_evaluation as cli_meval  # noqa: E402
from dgmesh_torch.cli import render_test as cli_render  # noqa: E402
from dgmesh_torch.cli import render_trajectory as cli_traj  # noqa: E402
from dgmesh_torch.cli import train as cli_train  # noqa: E402
from dgmesh_torch.config import Config  # noqa: E402
from dgmesh_torch.data.synthetic_mesh import generate_mesh_dataset  # noqa: E402
from dgmesh_torch.train.loop import log_line  # noqa: E402

torch.set_num_threads(1)

ITERS = 6
EVAL_FRAMES = 3
CONFIG = dict(data_type="finetune-nerf", is_blender=True, white_background=False, eval=True,
              grid_res=32, sh_degree=1, gaussian_ratio=1.2, iterations=ITERS, warm_up=1,
              densify_from_iter=1, densify_until_iter=3, densification_interval=2,
              dpsr_iter=4, normal_warm_up=1, normal_net_warmup=1, anchor_iter=100,
              opacity_reset_interval=100_000, dpsr_sig=2.0, log_every=2, max_gaussians=512,
              max_verts=16384, max_faces=32768, max_gaussians_per_tile=64, max_dup=1 << 12,
              max_faces_per_tile=1024, max_face_dup=1 << 16, mr_cull_backface=True, occ_res=16)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data, out = str(root / "data"), str(root / "out")
    generate_mesh_dataset(data, n_frames=4, width=64, height=64, n_test=1, subdiv=3,
                          n_eval_meshes=EVAL_FRAMES, device="cpu")
    yml = root / "tiny.yaml"
    yml.write_text(yaml.safe_dump(CONFIG))
    argv = ["--config", str(yml), "-s", data, "-m", out, "--save_iterations", "5"]
    trainer, results = cli_train.main(argv + ["--export_meshes", str(EVAL_FRAMES)],
                                      device="cpu")
    return dict(root=root, data=data, out=out, yml=str(yml), argv=argv, trainer=trainer,
                results=results)


def test_train_cli_writes_its_run(trained):
    """The config the run used, the log (every log_every and the last
    iteration, finite, the mesh phase in it), the checkpoints at 5 and at
    the end with the PLY and the nets, and the test results."""
    out = Path(trained["out"])
    cfg = Config.load(str(out / "cfg_args.json"))
    assert cfg.model.grid_res == 32 and cfg.optimization.dpsr_iter == 4
    assert cfg.model.source_path == trained["data"]
    rows = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [2, 4, 6]
    assert all(r["loss"] == r["loss"] and r["nonfinite_grad_leaves"] == 0 for r in rows)
    assert "mesh_psnr" not in rows[0] and rows[1]["mesh_n_verts"] > 0
    assert rows[2]["mesh_overflow"] == 0
    assert sorted(os.listdir(out / "checkpoint")) == ["state_5.pt", f"state_{ITERS}.pt"]
    assert (out / "point_cloud" / f"iteration_{ITERS}" / "point_cloud.ply").exists()
    for name in ("deform", "deform_normal", "deform_back", "deform_back_normal", "appearance"):
        assert (out / name / f"iteration_{ITERS}" / f"{name}.pt").exists()
    text = (out / "test_results" / "test_result.txt").read_text()
    assert {ln.split(":")[0] for ln in text.splitlines()} == set(trained["results"])
    assert {"psnr", "ssim", "mesh_psnr", "mesh_ssim", "fps"} <= set(trained["results"])
    assert int(trained["trainer"].state.step) == ITERS


def test_render_test_cli_reads_the_run_back(trained):
    """render_test with --device cpu (the flag, not the argument) loads the
    stored config and the last checkpoint and gives the training run's test
    metrics again (the same state, the same renders on the CPU), writing
    each view's images and mesh."""
    got = cli_render.main(["-m", trained["out"], "--device", "cpu"])
    for k, v in trained["results"].items():
        if k != "fps":
            assert got[k] == v, k
    files = sorted(os.listdir(Path(trained["out"]) / "test_renders"))
    gif = ["test.gif"] if importlib.util.find_spec("imageio") else []
    assert files == ["mesh_000.ply", "mesh_000.png", "render_000.png"] + gif


def test_train_cli_resumes_from_its_checkpoint(trained, tmp_path):
    """--start_checkpoint: a new run from the first run's folder starts at
    its last step and trains on to --quit_after; with --profile_iters 1 its
    first iteration runs under torch.profiler (a Chrome trace written)."""
    out = str(tmp_path / "resumed")
    argv = ["--config", trained["yml"], "-s", trained["data"], "-m", out,
            "--start_checkpoint", trained["out"], "--quit_after", str(ITERS + 2),
            "--profile_iters", "1"]
    trainer, _ = cli_train.main(argv, device="cpu")
    assert int(trainer.state.step) == ITERS + 2
    rows = [json.loads(line) for line in Path(out, "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [ITERS + 1, ITERS + 2]
    trace = json.loads(Path(out, "profile", "trace.json").read_text())
    assert len(trace["traceEvents"]) > 100


def test_debug_images(trained, tmp_path):
    """save_debug_images (--log_images): the GS render, and in the mesh
    phase the mesh image, the mask and the mesh (reference
    train.py:323-386)."""
    trained["trainer"].save_debug_images(ITERS, str(tmp_path))
    assert sorted(p.name for p in (tmp_path / "logs").iterdir()) == [
        f"mask_{ITERS:06d}.png", f"mesh_{ITERS:06d}.png", f"render_{ITERS:06d}.png"]
    assert (tmp_path / "logs_geo" / f"mesh_{ITERS:06d}.ply").exists()


def test_resumed_iteration_is_the_uninterrupted_one_bit_for_bit(trained):
    """A fresh Trainer from the run's checkpoint at 5 runs iteration 6 (a
    mesh iteration) and gives the state the uninterrupted run saved at 6,
    bit for bit: the checkpoint holds everything an iteration reads, and
    the iteration's random stream depends on (seed, iteration) only."""
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.loop import Trainer
    cfg = Config.load(os.path.join(trained["out"], "cfg_args.json"))
    tr = Trainer(cfg, Scene(cfg, shuffle=True, seed=6666), seed=6666, device="cpu",
                 state=load_checkpoint(cfg, trained["out"], 5, device="cpu"))
    tr.run_iteration(ITERS)
    want = load_checkpoint(cfg, trained["out"], ITERS, device="cpu")
    for tree in ("gp", "gs", "g_mu", "g_nu"):
        for a, b in zip(getattr(tr.state, tree), getattr(want, tree)):
            assert torch.equal(a, b), tree
    for a, b in zip(tr.state.nets, want.nets):
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    for a, b in zip(tr.state.net_opt, want.net_opt):
        assert torch.equal(a.count, b.count)
        assert all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu))


def test_clis_need_a_gpu_unless_asked_for_the_cpu(trained, monkeypatch, tmp_path):
    """Without --device (or the device argument) every CLI runs on cuda and
    raises where there is none; --export_meshes is ported (the fixture's
    run exported its meshes)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_train.main(trained["argv"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_render.main(["-m", trained["out"]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_traj.main(["-m", trained["out"], "--n_views", "1", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_meval.main(["--gt_dir", os.path.join(trained["data"], "gt_eval"), "--pred_dir",
                        os.path.join(trained["out"], "meshes"), "--out",
                        str(tmp_path / "eval.txt")])
    assert len(os.listdir(Path(trained["out"]) / "meshes")) == EVAL_FRAMES


def test_log_line_carries_jax_markers():
    m = dict(loss=1.0, img_psnr=20.0, mesh_psnr=18.0, n_alive=10, iters_per_sec=2.0,
             psr_min=-1.0, psr_max=1.0, mesh_n_verts=5, mesh_n_faces=6, density_thres=0.1,
             normal_norm=1.0, mesh_overflow=3, nonfinite_grad_leaves=2, splat_overflow=4,
             raster_overflow=0, splat_dup_overflow=1)
    line = log_line(7, m)
    assert line.startswith("[7] loss=1.0000 psnr=20.00 mesh_psnr=18.00 alive=10 it/s=2.00")
    assert "!! MESH OVERFLOW 3" in line and "!! NONFINITE GRADS zeroed (2 leaves)" in line
    assert "[tile-K ovf s=4 r=0 dup=1]" in line
    assert log_line(1, dict(loss=1.0, iters_per_sec=1.0)) == \
        "[1] loss=1.0000 psnr=0.00 alive=0 it/s=1.00"


def test_test_pass_renders_an_empty_mesh(trained):
    """Before the mesh phase the field can be flat and the mesh empty (zero
    normals): the test pass still renders every view, the mesh image
    the background, as JAX's padded render does (a zero-row net input
    once failed in the positional encoding)."""
    from dgmesh_torch.eval.testing import render_frame, run_testing
    from dgmesh_torch.train.step import make_batch
    tr = trained["trainer"]
    tr_empty = type(tr)(tr.cfg, tr.scene, device="cpu")     # a fresh state: zero normals
    cam = tr.scene.test_cameras[0]
    out = render_frame(tr_empty.ctx, tr_empty.state, make_batch(cam, 0.25, tr.bg, "cpu"), 1)
    assert int(out["n_faces"]) == 0 and not out["mesh_image"].any() and not out["mask"].any()
    res = run_testing(tr.cfg, tr_empty, tr.scene)
    assert all(v == v for v in res.values()) and "mesh_psnr" in res


# --- module 4: the mesh export, the trajectory and the mesh evaluation --------


def test_train_cli_exports_the_mesh_sequence(trained):
    """--export_meshes 3 reaches export_dynamic_meshes: mesh_00000..2.ply
    under OUT/meshes, each the final state's mesh at t = 0, 0.5, 1 (the
    same counts as a direct export from the run's trainer)."""
    from dgmesh_torch.eval.testing import export_dynamic_meshes
    from dgmesh_torch.utils_io import read_mesh_ply
    meshes = Path(trained["out"]) / "meshes"
    assert sorted(os.listdir(meshes)) == [f"mesh_{i:05d}.ply" for i in range(EVAL_FRAMES)]
    tr = trained["trainer"]
    frames = export_dynamic_meshes(tr.cfg, tr, tr.scene, str(trained["root"] / "again"),
                                   EVAL_FRAMES)
    for i, fr in enumerate(frames):
        v, f = read_mesh_ply(str(meshes / f"mesh_{i:05d}.ply"))
        assert (len(v), len(f)) == (fr["n_verts"], fr["n_faces"]) and len(f) > 0
        assert fr["mesh_overflow"] == 0 and np.isfinite(v).all()


def test_render_trajectory_panels_are_the_renders(trained, tmp_path):
    """render_trajectory --n_views 2 writes (H, 2W, 3) panels, each the
    port's render_frame mesh image | render_mesh_shape of that orbit view
    after the PNG's 8-bit rounding, and the GIF where imageio is
    installed."""
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.eval.testing import render_frame
    from dgmesh_torch.ops import mesh_raster as MR
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.loop import Trainer
    from dgmesh_torch.train.step import make_batch
    from dgmesh_torch.utils_io import read_png
    panels = cli_traj.main(["-m", trained["out"], "--n_views", "2", "--out", str(tmp_path)],
                           device="cpu")
    gif = ["trajectory.gif"] if importlib.util.find_spec("imageio") else []
    assert sorted(os.listdir(tmp_path)) == ["frame_000.png", "frame_001.png"] + gif
    cfg = Config.load(os.path.join(trained["out"], "cfg_args.json"))
    scene = Scene(cfg, shuffle=False)
    tr = Trainer(cfg, scene, state=load_checkpoint(cfg, trained["out"], -1, device="cpu"),
                 device="cpu")
    for i, cam in enumerate(cli_traj.trajectory_cameras(scene.train_cameras[0], 2, 3.0, 0.3)):
        b = make_batch(cam, scene.time_interval, tr.bg, "cpu")
        out = render_frame(tr.ctx, tr.state, b, cfg.model.sh_degree)
        fv = torch.arange(out["faces"].shape[0]) < out["n_faces"]
        shape = MR.render_mesh_shape(out["verts"], out["faces"], fv, b.mesh_pose, b.mesh_proj,
                                     cam.camera_center, tr.ctx.mr_cfg)
        want = np.concatenate([out["mesh_image"].permute(1, 2, 0).numpy(),
                               shape["rgb"].numpy()], axis=1)
        want = (np.clip(want, 0, 1) * 255).astype(np.uint8)
        assert want.shape == (64, 128, 3) and panels[i].shape == (64, 128, 3)
        assert (shape["mask"] > 0).any()
        np.testing.assert_array_equal(read_png(str(tmp_path / f"frame_{i:03d}.png")), want)


def test_gifs_are_skipped_without_imageio(trained, tmp_path, monkeypatch, capsys):
    """Where imageio does not import (as on the card), render_test and
    render_trajectory write their PNGs, no GIF, and say so (the test
    renders' GIF is otherwise written where imageio imports)."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    cli_traj.main(["-m", trained["out"], "--n_views", "1", "--out", str(tmp_path / "t")],
                  device="cpu")
    cli_render.main(["-m", trained["out"], "--out", str(tmp_path / "r")], device="cpu")
    said = capsys.readouterr().out
    assert "gif export skipped" in said and "video export skipped" in said
    assert os.listdir(tmp_path / "t") == ["frame_000.png"]
    assert "test.gif" not in os.listdir(tmp_path / "r")


def _eval_numbers(path):
    """eval_results.txt → [(cd, emd) per frame], (mean cd, mean emd)."""
    lines = Path(path).read_text().splitlines()
    frames = [(float(ln.split()[3]), float(ln.split()[5])) for ln in lines[:-2]]
    return frames, (float(lines[-2].split()[-1]), float(lines[-1].split()[-1]))


def test_mesh_evaluation_matches_jax(trained, tmp_path, monkeypatch):
    """The exported meshes against the dataset's GT meshes with JAX's recipe
    (--transforms, the default --method) at --emd_samples 256: the same
    eval_results.txt lines as JAX's CLI on the same files, CD within the
    kNN expansion's abs 1e-6 and EMD within 1e-5 relative, each plus the
    text's 6-decimal rounding (5e-7)."""
    import dgmesh_tpu.cli as jcli
    from dgmesh_tpu.cli import mesh_evaluation as jax_meval
    monkeypatch.setattr(jcli, "apply_platform_override", lambda: None)   # no compile cache
    argv = ["--gt_dir", os.path.join(trained["data"], "gt_eval"), "--pred_dir",
            os.path.join(trained["out"], "meshes"), "--transforms",
            os.path.join(trained["data"], "transforms_train.json"), "--emd_samples", "256"]
    jax_meval.main(argv + ["--out", str(tmp_path / "jax.txt")])
    pairs = cli_meval.main(argv + ["--out", str(tmp_path / "port.txt")], device="cpu")
    (jf, jm), (tf, tm) = _eval_numbers(tmp_path / "jax.txt"), _eval_numbers(tmp_path / "port.txt")
    assert len(tf) == len(jf) == len(pairs) == EVAL_FRAMES
    for (jcd, jemd), (tcd, temd) in zip(jf + [jm], tf + [tm]):
        assert abs(tcd - jcd) <= 1e-6 + 1e-6, (tcd, jcd)
        assert abs(temd - jemd) <= 1e-5 * jemd + 1e-6, (temd, jemd)
        assert np.isfinite([tcd, temd]).all() and temd > 0


def test_mesh_evaluation_of_the_gt_against_itself(trained, tmp_path):
    """The GT meshes written as PLY and evaluated against themselves with
    --method none and no --transforms: CD below 1e-6 (the float32 rounding
    of the distance expansion at radius ~0.5)."""
    from dgmesh_torch.utils_io import read_obj, write_mesh_ply
    gt = os.path.join(trained["data"], "gt_eval")
    for name in sorted(os.listdir(gt)):
        v, f = read_obj(os.path.join(gt, name))
        write_mesh_ply(str(tmp_path / "pred" / name.replace(".obj", ".ply")), v, f)
    pairs = cli_meval.main(["--gt_dir", gt, "--pred_dir", str(tmp_path / "pred"), "--method",
                            "none", "--emd_samples", "64", "--out", str(tmp_path / "e.txt")],
                           device="cpu")
    assert len(pairs) == EVAL_FRAMES and all(cd < 1e-6 for cd, _ in pairs)


# --- evaluation from a checkpoint and the quality recipe ------------------------

EVAL_ARGV = ["--n_meshes", "2", "--emd_samples", "64", "--device", "cpu"]


def _copy_run(trained, dst):
    """What cli.evaluate and make_quality_md read of the run (its config,
    checkpoints and log) in a folder of its own: the run's files stay as
    cli.train left them."""
    shutil.copytree(Path(trained["out"]) / "checkpoint", dst / "checkpoint")
    for name in ("cfg_args.json", "train_log.jsonl"):
        shutil.copy(Path(trained["out"]) / name, dst / name)
    return str(dst)


def _timeless(results):
    return {k: v for k, v in results.items() if k != "fps"}


@pytest.fixture(scope="module")
def evaluated(trained, tmp_path_factory):
    """cli.evaluate -m COPY -s DATA --n_meshes 2 --emd_samples 64 --device cpu
    on a copy of the run."""
    run = _copy_run(trained, tmp_path_factory.mktemp("evaluated"))
    results, pairs = cli_eval.main(["-m", run, "-s", trained["data"]] + EVAL_ARGV)
    return dict(run=Path(run), results=results, pairs=pairs)


def test_evaluate_cli_is_the_three_steps_on_the_checkpoint(trained, evaluated, tmp_path):
    """cli.evaluate's files bit for bit those of run_testing (with
    write_test_results), export_dynamic_meshes and cli.mesh_evaluation.main
    called on the same checkpoint: test_result.txt (but its fps line, a
    time), each test view's renders and mesh, the two PLYs (t = 0 and 1)
    and eval_results.txt."""
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.eval.testing import export_dynamic_meshes, run_testing, write_test_results
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.loop import Trainer
    cfg = Config.load(os.path.join(trained["out"], "cfg_args.json"))
    scene = Scene(cfg, shuffle=False)
    tr = Trainer(cfg, scene, state=load_checkpoint(cfg, trained["out"], -1, device="cpu"),
                 device="cpu")
    a, b = evaluated["run"], tmp_path
    want = run_testing(cfg, tr, scene, save_dir=str(b / "test_results"))
    write_test_results(want, str(b / "test_results"))
    export_dynamic_meshes(cfg, tr, scene, str(b / "meshes"), 2)
    pairs = cli_meval.main(["--gt_dir", os.path.join(trained["data"], "gt_eval"), "--pred_dir",
                            str(b / "meshes"), "--transforms",
                            os.path.join(trained["data"], "transforms_train.json"),
                            "--emd_samples", "64", "--out", str(b / "eval_results.txt")],
                           device="cpu")
    assert _timeless(evaluated["results"]) == _timeless(want)
    assert evaluated["pairs"] == pairs and len(pairs) == 2
    for sub in ("test_results", "meshes"):
        names = sorted(os.listdir(b / sub))
        assert sorted(os.listdir(a / sub)) == names, sub
        for name in names:
            got, exp = (a / sub / name).read_bytes(), (b / sub / name).read_bytes()
            if name == "test_result.txt":
                got, exp = (b"".join(ln for ln in t.splitlines(True) if not ln.startswith(b"fps:"))
                            for t in (got, exp))
            assert got == exp, name
    assert sorted(os.listdir(a / "meshes")) == ["mesh_00000.ply", "mesh_00001.ply"]
    assert (a / "eval_results.txt").read_bytes() == (b / "eval_results.txt").read_bytes()


def test_evaluate_cli_takes_an_older_checkpoint_and_skips_cd(trained, tmp_path):
    """--iteration 5 evaluates state_5.pt (run_testing's metrics on it, not
    the final state's); --skip_cd writes no eval_results.txt."""
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.eval.testing import run_testing
    from dgmesh_torch.train.checkpoint import load_checkpoint
    from dgmesh_torch.train.loop import Trainer
    run = _copy_run(trained, tmp_path / "run")
    results, pairs = cli_eval.main(["-m", run, "-s", trained["data"], "--iteration", "5",
                                    "--skip_cd", "--n_meshes", "1", "--device", "cpu"])
    cfg = Config.load(os.path.join(trained["out"], "cfg_args.json"))
    scene = Scene(cfg, shuffle=False)
    tr = Trainer(cfg, scene, state=load_checkpoint(cfg, trained["out"], 5, device="cpu"),
                 device="cpu")
    assert _timeless(results) == _timeless(run_testing(cfg, tr, scene))
    assert _timeless(results) != _timeless(trained["results"])
    assert pairs is None and not os.path.exists(os.path.join(run, "eval_results.txt"))
    assert os.listdir(os.path.join(run, "meshes")) == ["mesh_00000.ply"]


def test_evaluate_cli_needs_a_gpu_unless_asked_for_the_cpu(trained, monkeypatch, tmp_path):
    """Without --device cli.evaluate runs on cuda, and raises where there is
    none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = _copy_run(trained, tmp_path / "run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_eval.main(["-m", run, "-s", trained["data"], "--n_meshes", "1"])
    assert sorted(os.listdir(run)) == ["cfg_args.json", "checkpoint", "train_log.jsonl"]


def test_make_quality_md_reads_the_ports_run(evaluated, tmp_path):
    """tools/make_quality_md.py on the evaluated run: the training log, every
    line of test_result.txt and the tail of eval_results.txt in QUALITY.md,
    nothing reported missing."""
    out = tmp_path / "QUALITY.md"
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "make_quality_md.py"), "--run",
                        str(evaluated["run"]), "--out", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    text = out.read_text()
    assert "MISSING" not in text and f"reached iteration **{ITERS}**" in text
    for line in (evaluated["run"] / "test_results" / "test_result.txt").read_text().splitlines():
        assert line in text
    assert (evaluated["run"] / "eval_results.txt").read_text().splitlines()[-1] in text


def test_quality_recipe_script_names_what_the_port_has(monkeypatch):
    """tools/torch_run_quality.sh passes ``bash -n``; each ``python -m``
    module it runs imports, and its parser takes the flags the script
    passes (the shell variables at the script's defaults, resumed); its
    dataset call binds to generate_mesh_dataset's signature."""
    import ast
    import importlib
    import inspect
    import re
    import shlex
    script = ROOT / "tools" / "torch_run_quality.sh"
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    text = "".join(ln for ln in script.read_text().splitlines(True) if not ln.startswith("#"))
    env = dict(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}$", text, re.M))
    assert set(env) == {"DS", "RUN", "CFG"}
    text = re.sub(r"\$(\w+)", lambda m: env.get(m.group(1), m.group(0)), text.replace("\\\n", " "))
    monkeypatch.chdir(ROOT)
    cmds = re.findall(r"python -m (\S+)(.*)", text)
    assert [m for m, _ in cmds] == ["dgmesh_torch.cli.train", "dgmesh_torch.cli.mesh_evaluation"]
    for module, rest in cmds:
        argv = shlex.split(rest.replace('"${RESUME[@]}"', f"--start_checkpoint {env['RUN']}"))
        parsed = importlib.import_module(module).parse(argv)
        if module.endswith("train"):
            args, cfg = parsed
            assert args.export_meshes == 200 and args.start_checkpoint == env["RUN"]
            assert cfg.model.pretrain_mesh_path == env["DS"] + "/mesh"
        else:
            assert parsed.transforms == env["DS"] + "/transforms_train.json"
    (call,) = [n for n in ast.walk(ast.parse(text.split("<<PY\n")[1].split("\nPY\n")[0]))
               if isinstance(n, ast.Call)]
    inspect.signature(generate_mesh_dataset).bind(
        *[ast.literal_eval(a) for a in call.args],
        **{k.arg: ast.literal_eval(k.value) for k in call.keywords})
    assert call.func.id == "generate_mesh_dataset"


# --- module 3's remainder: the real captures and the D-NeRF generator ---------

CAPTURE_CONFIG = dict(CONFIG, data_type="Nerfies", is_blender=False, white_background=True,
                      iterations=4, dpsr_iter=3, densify_until_iter=2)
CAPTURE_W, CAPTURE_H = 56, 72      # portrait, not a multiple of the 16-pixel tile wide


@pytest.fixture(scope="module")
def captured(tmp_path_factory):
    """The GT-mesh scene in the three real-capture layouts (3 training and 1
    validation frames, 56×72, off-centre K, palette and greyscale masks),
    and a 4-iteration cli.train run on the Nerfies one."""
    from dgmesh_torch.data.synthetic_mesh import generate_capture_datasets
    root = tmp_path_factory.mktemp("capture")
    paths = generate_capture_datasets(str(root / "data"), n_train=3, n_val=1, width=CAPTURE_W,
                                      height=CAPTURE_H, subdiv=3, max_per_tile=1024,
                                      device="cpu")
    yml = root / "nerfies.yaml"
    yml.write_text(yaml.safe_dump(CAPTURE_CONFIG))
    out = str(root / "out")
    trainer, results = cli_train.main(["--config", str(yml), "-s", paths["Nerfies"], "-m", out],
                                      device="cpu")
    return dict(paths=paths, out=out, trainer=trainer, results=results)


def test_train_and_render_test_clis_on_a_nerfies_capture(captured):
    """data_type Nerfies through cli.train: every logged loss finite, the
    mesh phase reached without overflow, the test pass over the validation
    frame finite; cli.render_test renders it again (the same metrics on the
    CPU) and writes its files."""
    out = Path(captured["out"])
    rows = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["iter"] for r in rows] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["nonfinite_grad_leaves"] == 0 for r in rows)
    assert rows[-1]["mesh_n_verts"] > 0 and rows[-1]["mesh_overflow"] == 0
    tr = captured["trainer"]
    assert not tr.cfg.model.is_blender and tr.ctx.splat_cfg.width == CAPTURE_W
    assert all(np.isfinite(v) for v in captured["results"].values())
    got = cli_render.main(["-m", captured["out"], "--device", "cpu"])
    for k, v in captured["results"].items():
        if k != "fps":
            assert got[k] == v, k
    files = sorted(os.listdir(out / "test_renders"))
    assert {"mesh_000.ply", "mesh_000.png", "render_000.png"} <= set(files)


def test_capture_layouts_read_back_as_the_same_cameras(captured):
    """The three layouts through Scene under their configs' data_type: the
    same cameras (Nerfies' recentred and scaled positions back in the
    world, K from the full-resolution json halved), frames and masks; the
    Nerfies layout read by JAX's Scene too, exactly as the port reads it
    (the port's palette PNGs through Pillow); one view of each rendered
    from the trained state."""
    from dgmesh_torch.data.scene import Scene
    from dgmesh_torch.eval.testing import render_frame
    from dgmesh_torch.train.step import make_batch
    from dgmesh_tpu.config import Config as JConfig
    from dgmesh_tpu.data.scene import Scene as JScene
    scenes = {}
    for layout, path in captured["paths"].items():
        cfg = Config()
        cfg.model.source_path, cfg.model.data_type = path, layout
        cfg.model.white_background, cfg.model.eval = True, True
        np.random.seed(0)
        scenes[layout] = Scene(cfg, shuffle=False)
    base = scenes["NeuralActor"]
    for layout, s in scenes.items():
        assert len(s.train_cameras) == 3 and len(s.test_cameras) == 1
        for a, b in zip(s.train_cameras + s.test_cameras, base.train_cameras + base.test_cameras):
            assert (a.width, a.height) == (CAPTURE_W, CAPTURE_H) and a.fid == b.fid
            np.testing.assert_allclose(a.R, b.R, rtol=0, atol=1e-12)
            np.testing.assert_allclose(a.T, b.T, rtol=0, atol=1e-12)
            np.testing.assert_array_equal(a.K, b.K)
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_array_equal(a.alpha_mask, b.alpha_mask)
            assert a.K[0, 2] != CAPTURE_W / 2 and 0.05 < a.alpha_mask.mean() < 0.9
    jc = JConfig()
    jc.model.source_path, jc.model.data_type = captured["paths"]["Nerfies"], "Nerfies"
    jc.model.white_background, jc.model.eval = True, True
    np.random.seed(0)
    js = JScene(jc, shuffle=False)
    for a, b in zip(scenes["Nerfies"].train_cameras, js.train_cameras):
        for f in ("R", "T", "K", "image", "alpha_mask", "orig_transform"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(scenes["Nerfies"].point_cloud.points, js.point_cloud.points)
    tr = captured["trainer"]
    for layout in ("iPhone", "NeuralActor"):
        cam = scenes[layout].test_cameras[0]
        out = render_frame(tr.ctx, tr.state, make_batch(cam, 0.25, tr.bg, "cpu"), 1)
        assert out["render"].shape == (3, CAPTURE_H, CAPTURE_W)
        assert bool(torch.isfinite(out["render"]).all()) and int(out["n_faces"]) > 0


def test_generate_dataset_matches_jax(tmp_path):
    """data/synthetic.py's D-NeRF generator against JAX's at 48² (3 + 1
    frames, 400 Gaussians, the same numpy draws): the transforms and the
    init cloud byte for byte, each frame within one 8-bit step of JAX's
    (the two splat renderers' float32 sums round across a quantisation
    boundary at a few pixels); the port's dataset read back through its
    Blender reader."""
    from dgmesh_torch.data import synthetic as TS
    from dgmesh_torch.data.readers import read_blender_scene
    from dgmesh_tpu.data import synthetic as JS
    from PIL import Image
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(n_frames=3, width=48, height=48, n_gaussians=400, n_test=1, seed=2)
    JS.generate_dataset(jdir, **kw)
    TS.generate_dataset(tdir, device="cpu", **kw)
    for name in ("transforms_train.json", "transforms_test.json", "points3d.ply"):
        assert Path(tdir, name).read_bytes() == Path(jdir, name).read_bytes(), name
    worst, moved = 0, 0
    for split, n in (("train", 3), ("test", 1)):
        for i in range(n):
            want = np.asarray(Image.open(Path(jdir, split, f"r_{i:03d}.png"))).astype(int)
            got = np.asarray(Image.open(Path(tdir, split, f"r_{i:03d}.png"))).astype(int)
            assert got.shape == want.shape == (48, 48, 4) and (want[..., 3] > 0).mean() > 0.1
            worst = max(worst, int(np.abs(got - want).max()))
            moved += int((got != want).any(-1).sum())
    assert worst <= 1 and moved <= 0.01 * 48 * 48 * 4
    info = read_blender_scene(tdir, white_background=False)
    assert len(info.train_cameras) == 3 and len(info.test_cameras) == 1
    assert [c.fid for c in info.train_cameras] == [0.0, 0.5, 1.0]
    assert info.point_cloud.points.shape == (1600, 3)


def test_pose_utils_match_jax():
    """The port's pose_utils (what mesh_evaluation takes its rotations from)
    against JAX's: pose_spherical, the Rodrigues pair, render_wander_path
    and the rotations, exactly."""
    from dgmesh_torch import pose_utils as TP
    from dgmesh_torch.cameras import camera_from_c2w_blender
    from dgmesh_tpu import pose_utils as JP
    from dgmesh_tpu.cli import mesh_evaluation as jax_meval
    for args in ((30.0, -20.0, 4.0), (-170.0, 85.0, 2.5)):
        np.testing.assert_array_equal(TP.pose_spherical(*args), JP.pose_spherical(*args))
    r = np.array([0.3, -0.2, 0.9])
    np.testing.assert_array_equal(TP.rodrigues_rot_to_mat(r), JP.rodrigues_rot_to_mat(r))
    R = TP.rodrigues_rot_to_mat(r)
    np.testing.assert_array_equal(TP.rodrigues_mat_to_rot(R), JP.rodrigues_mat_to_rot(R))
    np.testing.assert_allclose(TP.rodrigues_mat_to_rot(R), r, rtol=0, atol=1e-12)
    cam = camera_from_c2w_blender(0, TP.pose_spherical(30.0, -20.0, 4.0), 0.7, 64, 48, 0.0)
    for a, b in zip(TP.render_wander_path(cam, 5), JP.render_wander_path(cam, 5)):
        np.testing.assert_array_equal(a, b)
    assert TP.ROTATIONS.keys() == jax_meval.ROTATIONS.keys()
    for k, v in jax_meval.ROTATIONS.items():
        np.testing.assert_array_equal(TP.ROTATIONS[k], v)
    assert cli_meval.ROTATIONS is TP.ROTATIONS
