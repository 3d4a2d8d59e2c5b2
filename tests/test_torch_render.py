"""The port's render path as a whole: render_frame against JAX, the import
rule, and the device rule."""

import ast
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, ROOT, jax_fixture, port_fixture, to_numpy

from dgmesh_tpu.eval.testing import render_frame as jax_render_frame

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rendered():
    """One render of the miniature fixture by each package (noise on the
    zero-init heads so the deformation and the normal offsets are live), at
    mesh capacities that hold the whole surface."""
    from dgmesh_torch.eval.testing import render_frame
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=7, **ROOMY)
    want = to_numpy(jax.jit(lambda st, b: jax_render_frame(ctx, st, b, 1, True))(state, batch))
    tcfg, tctx, tstate, tbatch = port_fixture(cfg, img, state)
    got = {k: v.numpy() for k, v in render_frame(tctx, tstate, tbatch, 1, True).items()}
    return got, want


def test_render_frame_images_match_jax(rendered):
    """GS image, mesh image and mask: abs 1e-4 (f32 projection, DPSR and
    compositing sums in other orders; both sides run the kernels' math)."""
    got, want = rendered
    assert set(got) == set(want)
    for k in ("render", "mesh_image", "mask"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert want["mask"].mean() > 0.05 and want["render"].max() > 0.1


def test_render_frame_mesh_matches_jax(rendered):
    """n_verts, n_faces and faces exact; verts and vtx_color abs 1e-5."""
    got, want = rendered
    assert int(got["n_verts"]) == int(want["n_verts"]) > 100
    assert int(got["n_faces"]) == int(want["n_faces"]) > 100
    np.testing.assert_array_equal(got["faces"], want["faces"])
    np.testing.assert_allclose(got["verts"], want["verts"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["vtx_color"], want["vtx_color"], rtol=0, atol=1e-5)


def test_render_frame_without_mesh_matches_jax():
    from dgmesh_torch.eval.testing import render_frame
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=8)
    want = to_numpy(jax.jit(lambda st, b: jax_render_frame(ctx, st, b, 1, False))(state, batch))
    _, tctx, tstate, tbatch = port_fixture(cfg, img, state)
    got = render_frame(tctx, tstate, tbatch, 1, with_mesh=False)
    assert set(got) == set(want) == {"render"}
    np.testing.assert_allclose(got["render"].numpy(), want["render"], rtol=0, atol=1e-4)


# --- an off-centre camera of a real capture -----------------------------------

OFF_W, OFF_H = 72, 56        # neither a multiple of the 16-pixel tile


def _off_centre_cameras():
    """The same camera for both packages: an OpenCV pose at distance 2.5
    turned 0.3 rad about y, K with fx ≠ fy and the principal point at (0.56
    W, 0.43 H), as a Nerfies or NeuralActor reader builds it."""
    from dgmesh_torch.cameras import Camera as TCamera
    from dgmesh_torch.cameras import focal2fov
    from dgmesh_tpu.cameras import Camera as JCamera
    a = 0.3
    c2w = np.eye(4)
    c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    c2w[:3, 3] = c2w[:3, :3] @ [0, 0, 2.5]
    c2w_cv = c2w.copy()
    c2w_cv[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w_cv)
    K = np.array([[70.0, 0, 0.56 * OFF_W], [0, 66.0, 0.43 * OFF_H], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(4)
    kw = dict(uid=0, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=focal2fov(70.0, OFF_W),
              fovy=focal2fov(66.0, OFF_H), image=rng.random((OFF_H, OFF_W, 3)).astype(np.float32),
              alpha_mask=np.ones((OFF_H, OFF_W, 1), np.float32), fid=0.4, width=OFF_W,
              height=OFF_H, K=K, orig_transform=c2w.astype(np.float32))
    return TCamera(**kw), JCamera(**kw)


@pytest.fixture(scope="module")
def rendered_off_centre():
    """render_frame of the real-capture nets (is_blender False) through the
    off-centre camera, by each package."""
    from dgmesh_torch.eval.testing import render_frame
    from dgmesh_torch.train.step import StepContext, make_batch
    from dgmesh_tpu.train.loop import make_batch as jax_make_batch
    from dgmesh_tpu.train.step import StepContext as JStepContext
    cfg, img, _, state, _ = jax_fixture(head_std=1e-3, seed=9, is_blender=False, **ROOMY)
    tcam, jcam = _off_centre_cameras()
    bg = np.zeros(3, np.float32)
    jctx = JStepContext(cfg, OFF_W, OFF_H)
    want = to_numpy(jax.jit(lambda st, b: jax_render_frame(jctx, st, b, 1, True))(
        state, jax_make_batch(jcam, 0.05, bg)))
    tcfg, _, tstate, _ = port_fixture(cfg, img, state)
    got = render_frame(StepContext(tcfg, OFF_W, OFF_H, device="cpu"), tstate,
                       make_batch(tcam, 0.05, bg, device="cpu"), 1, True)
    return {k: v.numpy() for k, v in got.items()}, want


def test_off_centre_camera_render_matches_jax(rendered_off_centre):
    """A 72×56 frame (a partial last tile column and row) through K with its
    principal point off centre: the GS image, mesh image and mask at the
    tolerance of test_render_frame_images_match_jax, faces exactly, verts
    and colours abs 1e-5; the object sits off the image centre, as K puts
    it."""
    got, want = rendered_off_centre
    for k in ("render", "mesh_image", "mask"):
        assert got[k].shape[-2:] == want[k].shape[-2:] == (OFF_H, OFF_W), k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    assert int(got["n_faces"]) == int(want["n_faces"]) > 100
    np.testing.assert_array_equal(got["faces"], want["faces"])
    np.testing.assert_allclose(got["verts"], want["verts"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["vtx_color"], want["vtx_color"], rtol=0, atol=1e-5)
    m = want["mask"]
    assert 0.02 < m.mean() < 0.9 and m[:, -1].sum() == 0
    ys, xs = np.nonzero(m > 0.5)
    assert abs(xs.mean() - OFF_W / 2) > 1 or abs(ys.mean() - OFF_H / 2) > 1


# --- the import rule ---------------------------------------------------------

FORBIDDEN = ("jax", "flax", "optax", "msgpack", "dgmesh_tpu")


def _port_files():
    return (sorted((ROOT / "dgmesh_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("torch_*.py")))


def test_import_scan_covers_the_driver():
    """The scan reads the CLIs, the data readers, the eval modules, the
    multi-device modules, the entry module and the viewer stub."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"dgmesh_torch/parallel/sharding.py", "dgmesh_torch/parallel/sharded_splat.py",
            "dgmesh_torch/parallel/sharded_mr.py", "dgmesh_torch/parallel/sharded_dpsr.py",
            "dgmesh_torch/parallel/sharded_mt.py", "dgmesh_torch/graft_entry.py",
            "dgmesh_torch/ops/rigid.py"} <= names
    assert {"dgmesh_torch/cli/train.py", "dgmesh_torch/cli/render_test.py",
            "dgmesh_torch/cli/render_trajectory.py", "dgmesh_torch/cli/mesh_evaluation.py",
            "dgmesh_torch/data/readers.py", "dgmesh_torch/data/scene.py",
            "dgmesh_torch/train/checkpoint.py", "dgmesh_torch/ops/chamfer.py",
            "dgmesh_torch/eval/point_metrics.py", "dgmesh_torch/eval/lpips_torch.py",
            "dgmesh_torch/eval/testing.py", "dgmesh_torch/cli/evaluate.py",
            "dgmesh_torch/viewer.py", "dgmesh_torch/utils_io.py"} <= names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """AST scan: no import of jax, flax, optax, msgpack or dgmesh_tpu, at any
    depth (every file of the package, cli/ and data/ included)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_port_renders_on_cpu_without_jax():
    """A fresh interpreter imports the port (the structural ops and the
    training iteration too) and renders a small frame on the CPU; jax is
    never loaded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        from dgmesh_torch.cameras import camera_from_c2w_blender
        from dgmesh_torch.config import Config
        from dgmesh_torch.eval.testing import render_frame
        from dgmesh_torch.train.state import init_state
        from dgmesh_torch.train.step import StepContext, make_batch
        from dgmesh_torch.ops import knn, occupancy  # noqa: F401  (the structural ops)
        from dgmesh_torch.train import checkpoint, densify, loop  # noqa: F401
        from dgmesh_torch.cli import render_test, train  # noqa: F401  (the CLIs)
        from dgmesh_torch.cli import mesh_evaluation, render_trajectory  # noqa: F401
        from dgmesh_torch.cli import evaluate  # noqa: F401
        from dgmesh_torch import viewer  # noqa: F401
        from dgmesh_torch.eval import lpips_torch, point_metrics  # noqa: F401
        from dgmesh_torch.data import colmap, readers, resize, scene  # noqa: F401
        from dgmesh_torch.data import synthetic, synthetic_mesh  # noqa: F401
        from dgmesh_torch import pose_utils  # noqa: F401
        cfg = Config()
        cfg.model.is_blender, cfg.model.grid_res, cfg.model.sh_degree = True, 24, 1
        cfg.optimization.dpsr_sig = 2.0
        t = cfg.tpu
        t.max_gaussians, t.max_verts, t.max_faces = 256, 4096, 8192
        t.max_gaussians_per_tile, t.max_faces_per_tile = 32, 32
        rng = np.random.default_rng(0)
        d = rng.normal(size=(200, 3)); d /= np.linalg.norm(d, axis=1, keepdims=True)
        st = init_state(cfg, (0.4 * d).astype(np.float32),
                        rng.random((200, 3)).astype(np.float32), device="cpu")
        normal = torch.zeros_like(st.gp.normal); normal[:200] = torch.tensor(d, dtype=torch.float32)
        st = st._replace(gp=st.gp._replace(normal=normal))
        c2w = np.eye(4, dtype=np.float32); c2w[2, 3] = 2.5
        cam = camera_from_c2w_blender(0, c2w, 0.9, 48, 48, 0.5)
        out = render_frame(StepContext(cfg, 48, 48, device="cpu"), st,
                           make_batch(cam, 0.05, np.zeros(3, np.float32), device="cpu"), 1)
        assert out["render"].shape == (3, 48, 48) and out["mesh_image"].shape == (3, 48, 48)
        assert int(out["n_faces"]) > 0 and bool(torch.isfinite(out["render"]).all())
        assert "jax" not in sys.modules and "dgmesh_tpu" not in sys.modules
        assert "msgpack" not in sys.modules and "PIL" not in sys.modules
        assert not [m for m in ("matplotlib", "imageio", "lpips") if m in sys.modules]
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(ROOT))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


# --- the device rule ---------------------------------------------------------

def test_default_device_raises_without_gpu(monkeypatch):
    from dgmesh_torch.config import Config
    from dgmesh_torch.device import resolve_device
    from dgmesh_torch.train.step import StepContext
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        StepContext(Config(), 32, 32)
    assert resolve_device("cpu") == torch.device("cpu")
    assert StepContext(Config(), 32, 32, device="cpu").device.type == "cpu"


def test_resolve_device_pins_float32_matmuls():
    from dgmesh_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    resolve_device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
