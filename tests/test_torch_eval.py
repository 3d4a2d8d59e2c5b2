"""The port's evaluation (module 4) against the JAX package's: Chamfer and
Sinkhorn EMD, the point-cloud metric suite, LPIPS on random weights,
``render_mesh_shape``, ``export_dynamic_meshes``, ``run_testing``'s LPIPS
columns and ``pointcloud_scatter_render``.

The renders run on the miniature parity fixture (tests/torch_parity_fixture.py:
grid 32, 512 Gaussian slots, 64², JAX's Pallas kernels in interpret mode)
at capacities that hold the whole mesh.  JAX compiles one render program
(its run_testing), one export program and one shape render.  Each test
states its tolerance.
"""

import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, ROOT, jax_fixture, port_fixture, to_numpy

sys.path.insert(0, str(ROOT))

from dgmesh_torch.eval import lpips_torch as TL  # noqa: E402
from dgmesh_torch.eval import point_metrics as TPM  # noqa: E402
from dgmesh_torch.eval import testing as TT  # noqa: E402
from dgmesh_torch.ops import chamfer as TC  # noqa: E402
from dgmesh_torch.ops import mesh_raster as TMR  # noqa: E402
from dgmesh_tpu.eval import lpips_jax as JL  # noqa: E402
from dgmesh_tpu.eval import point_metrics as JPM  # noqa: E402
from dgmesh_tpu.eval import testing as JT  # noqa: E402
from dgmesh_tpu.ops import chamfer as JC  # noqa: E402
from dgmesh_tpu.ops import mesh_raster as JMR  # noqa: E402

torch.set_num_threads(1)

TOL_KNN = 1e-6         # the kNN distance expansion at the meshes' scale (|p| <~ 1)
TOL_EMD_REL = 1e-5     # float32 logsumexp in another order over 600 iterations
TOL_LPIPS_REL = 1e-4   # tests/test_lpips_torch_agreement.py's bound
TOL_SHAPE = 1e-5       # per-pixel shading of the same winners: float32 in another order


def _cloud(rng, n, scale=0.5, shift=0.0):
    """Points in a box of half-side ``scale`` around ``shift``: the evaluated
    meshes' scale, where the distance expansion rounds at ~1e-7."""
    return (rng.uniform(-scale, scale, size=(n, 3)) + shift).astype(np.float32)


# --- chamfer and EMD -----------------------------------------------------------

@pytest.mark.parametrize("squared", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_matches_jax(squared, masked):
    """N = 300 against M = 200, with and without the valid masks: both
    directions' distances and CD within TOL_KNN."""
    rng = np.random.default_rng(3)
    a, b = _cloud(rng, 300), _cloud(rng, 200, 0.4, 0.1)
    av = bv = None
    if masked:
        av, bv = rng.random(300) > 0.3, rng.random(200) > 0.5
    want = JC.chamfer(jnp.asarray(a), jnp.asarray(b), None if av is None else jnp.asarray(av),
                      None if bv is None else jnp.asarray(bv), squared=squared)
    got = TC.chamfer(torch.tensor(a), torch.tensor(b), None if av is None else torch.tensor(av),
                     None if bv is None else torch.tensor(bv), squared=squared)
    for w, g, what in zip(want, got, ("cd", "d_a2b", "d_b2a")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL_KNN, err_msg=what)


def test_chamfer_identical_and_known_offset():
    """tests/test_geometry_ops.py's cases hold for the port: identical sets
    give 0; a 0.5 offset gives 0.25 each way."""
    a = torch.tensor(np.random.default_rng(0).normal(size=(256, 3)).astype(np.float32))
    assert float(TC.chamfer(a, a)[0]) < 1e-6
    b = torch.zeros((64, 3))
    b[:, 0] = 0.5
    np.testing.assert_allclose(float(TC.chamfer(torch.zeros((64, 3)), b)[0]), 0.5, atol=1e-5)


def test_emd_sinkhorn_matches_jax_and_the_exact_assignment():
    """n = 128 at the defaults: JAX's value within TOL_EMD_REL; and within
    JAX's calibration, 0.5% of the exact assignment's cost (scipy's
    linear_sum_assignment on float64 costs, tests/test_geometry_ops.py)."""
    from scipy.optimize import linear_sum_assignment
    r = np.random.default_rng(0)
    a = r.normal(size=(128, 3)).astype(np.float32)
    b = (r.normal(size=(128, 3)) * 0.8 + 0.2).astype(np.float32)
    want = float(JC.emd_sinkhorn(jnp.asarray(a), jnp.asarray(b)))
    got = float(TC.emd_sinkhorn(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, want, rtol=TOL_EMD_REL)
    C = np.linalg.norm(a[:, None].astype(np.float64) - b[None].astype(np.float64), axis=-1)
    i, j = linear_sum_assignment(C)
    exact = C[i, j].mean()
    assert abs(got - exact) / exact < 0.005, (got, exact)


def test_point_metrics_match_jax():
    """compute_all_metrics and emd_cd on three sample and three reference
    clouds of 64 points (one sample near the references, two far): every
    key within the Chamfer/EMD tolerances, COV and 1-NNA equal."""
    rng = np.random.default_rng(5)
    ref = [_cloud(rng, 64, 0.5) for _ in range(3)]
    smp = [ref[0] + rng.normal(0, 0.01, (64, 3)).astype(np.float32),
           _cloud(rng, 64, 0.3, 0.4), _cloud(rng, 64, 0.5, -0.2)]
    want = JPM.compute_all_metrics(smp, ref)
    got = TPM.compute_all_metrics(smp, ref, device="cpu")
    assert set(got) == set(want)
    for k in want:
        if "COV" in k or "1-NNA" in k:
            assert got[k] == want[k], k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL_KNN, err_msg=k)
    want = JPM.emd_cd(np.stack(smp), np.stack(ref), reduced=False)
    got = TPM.emd_cd(np.stack(smp), np.stack(ref), reduced=False, device="cpu")
    np.testing.assert_allclose(got["CD"], want["CD"], rtol=0, atol=TOL_KNN)
    np.testing.assert_allclose(got["EMD"], want["EMD"], rtol=TOL_EMD_REL)


# --- LPIPS ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_dir(tmp_path_factory):
    """Random AlexNet and VGG weights written by JAX's random_weights."""
    d = tmp_path_factory.mktemp("lpips")
    for net in ("alex", "vgg"):
        JL.random_weights(str(d / f"lpips_{net}.npz"), net, seed=1)
    return d


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_random_weights_are_jax_arrays(net, lpips_dir, tmp_path):
    TL.random_weights(str(tmp_path / "w.npz"), net, seed=1)
    got, want = np.load(tmp_path / "w.npz"), np.load(lpips_dir / f"lpips_{net}.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_rgb_lpips_matches_jax(net, lpips_dir, monkeypatch):
    """Random weights, 64² images: within TOL_LPIPS_REL of JAX's value."""
    monkeypatch.setenv("DGMESH_LPIPS_DIR", str(lpips_dir))
    rng = np.random.default_rng(2)
    img = rng.random((3, 64, 64)).astype(np.float32)
    gt = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1).astype(np.float32)
    want = JL.rgb_lpips(jnp.asarray(img), jnp.asarray(gt), net)
    got = TL.rgb_lpips(torch.tensor(img), torch.tensor(gt), net)
    assert np.isfinite(want) and want > 0
    np.testing.assert_allclose(got, want, rtol=TOL_LPIPS_REL)


def test_rgb_lpips_without_weights_is_nan(monkeypatch, tmp_path):
    for k in ("DGMESH_LPIPS_WEIGHTS_ALEX", "DGMESH_LPIPS_WEIGHTS", "DGMESH_LPIPS_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    assert not TL.lpips_available("alex")
    assert np.isnan(TL.rgb_lpips(torch.zeros(3, 8, 8), torch.zeros(3, 8, 8), "alex"))


def test_convert_torch_lpips_names_the_missing_package(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lpips", None)
    with pytest.raises(ImportError, match="lpips"):
        TL.convert_torch_lpips(str(tmp_path / "x.npz"))


# --- the renders on the parity fixture ----------------------------------------------

@pytest.fixture(scope="module")
def fx():
    """The parity fixture's state in both packages, with a test camera that
    carries a seeded GT image (the fixture's camera)."""
    from dgmesh_torch.cameras import camera_from_c2w_blender as t_cam
    from dgmesh_tpu.cameras import camera_from_c2w_blender as j_cam
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=7, **ROOMY)
    tcfg, tctx, tstate, tbatch = port_fixture(cfg, img, state)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    gt = np.random.default_rng(4).random((img, img, 3)).astype(np.float32)
    bg = np.zeros(3, np.float32)
    jax_side = (SimpleNamespace(ctx=ctx, state=state, bg=bg),
                SimpleNamespace(test_cameras=[j_cam(0, c2w, 0.9, img, img, 0.3, image=gt)],
                                time_interval=0.05))
    port_side = (SimpleNamespace(ctx=tctx, state=tstate, bg=bg),
                 SimpleNamespace(test_cameras=[t_cam(0, c2w, 0.9, img, img, 0.3, image=gt)],
                                 time_interval=0.05))
    return dict(cfg=cfg, tcfg=tcfg, ctx=ctx, tctx=tctx, tstate=tstate, tbatch=tbatch,
                jax=jax_side, port=port_side)


def test_render_mesh_shape_matches_jax(fx):
    """The fixture's mesh (the port's render of it) shaded by both packages'
    render_mesh_shape: face_id and mask equal; rgb, normal and position
    within TOL_SHAPE."""
    tb = fx["tbatch"]
    out = TT.render_frame(fx["tctx"], fx["tstate"], tb, 1, True)
    verts, faces = out["verts"], out["faces"]
    fvalid = torch.arange(faces.shape[0]) < out["n_faces"]
    cam_center = np.array([0.0, 0.0, 2.5], np.float32)
    got = TMR.render_mesh_shape(verts, faces, fvalid, tb.mesh_pose, tb.mesh_proj, cam_center,
                                fx["tctx"].mr_cfg)
    mr_cfg = fx["ctx"].mr_cfg
    want = jax.jit(lambda v, f, fv, p, q: JMR.render_mesh_shape(v, f, fv, p, q, cam_center,
                                                                  mr_cfg))(
        *(jnp.asarray(x.numpy()) for x in (verts, faces.int(), fvalid, tb.mesh_pose,
                                           tb.mesh_proj)))
    want = to_numpy(want)
    assert (want["face_id"] >= 0).mean() > 0.05
    np.testing.assert_array_equal(got["face_id"].numpy(), want["face_id"])
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    for k in ("rgb", "normal", "position"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=TOL_SHAPE, err_msg=k)


def test_export_dynamic_meshes_matches_jax(fx, tmp_path):
    """Three frames of the fixture's state: per frame V and F equal (the
    faces too), the vertices within the DPSR/marching-tets tolerance (abs
    1e-5) and the colours' uint8 within 1, as both packages read the PLY
    files; the frames' counts returned, no overflow."""
    from dgmesh_torch.utils_io import read_mesh_ply as t_read
    from dgmesh_tpu.utils_io import read_mesh_ply as j_read
    JT.export_dynamic_meshes(fx["cfg"], fx["jax"][0], fx["jax"][1], str(tmp_path / "j"), 3)
    frames = TT.export_dynamic_meshes(fx["tcfg"], fx["port"][0], fx["port"][1],
                                      str(tmp_path / "t"), 3)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        f"mesh_{i:05d}.ply" for i in range(3)]
    for i, fr in enumerate(frames):
        name = f"mesh_{i:05d}.ply"
        (jv, jf), (tv, tf) = j_read(str(tmp_path / "j" / name)), t_read(str(tmp_path / "t" / name))
        assert fr == dict(n_verts=len(jv), n_faces=len(jf), mesh_overflow=0) and len(jf) > 100
        assert tv.shape == jv.shape
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
        jc, tc = (_ply_colors(str(tmp_path / s / name), len(jv)) for s in ("j", "t"))
        assert np.abs(jc.astype(int) - tc.astype(int)).max() <= 1


def _ply_colors(path, n):
    """The uchar red, green, blue of a vertex record after x, y, z."""
    with open(path, "rb") as f:
        blob = f.read()
    start = blob.index(b"end_header\n") + len(b"end_header\n")
    rec = np.frombuffer(blob[start:start + 15 * n], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    return rec["rgb"]


def test_run_testing_lpips_columns_match_jax(fx, lpips_dir, monkeypatch):
    """With DGMESH_LPIPS_DIR at the random weights both test passes report
    lpips_alex, mesh_lpips_alex, lpips_vgg and mesh_lpips_vgg: within
    TOL_LPIPS_REL of JAX's; the other columns as the render tests bound the
    images (abs 1e-4 of a pixel: PSNR within 1e-2 dB, SSIM within 1e-4)."""
    monkeypatch.setenv("DGMESH_LPIPS_DIR", str(lpips_dir))
    want = JT.run_testing(fx["cfg"], *fx["jax"])
    got = TT.run_testing(fx["tcfg"], *fx["port"])
    cols = {"lpips_alex", "mesh_lpips_alex", "lpips_vgg", "mesh_lpips_vgg"}
    assert cols <= set(want) and set(got) == set(want)
    for k in cols:
        assert np.isfinite(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=TOL_LPIPS_REL, err_msg=k)
    for k in ("psnr", "mesh_psnr"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-2, err_msg=k)
    for k in ("ssim", "mesh_ssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4, err_msg=k)


def test_run_testing_without_weights_has_no_lpips_column(fx, monkeypatch, tmp_path):
    for k in ("DGMESH_LPIPS_WEIGHTS_ALEX", "DGMESH_LPIPS_WEIGHTS_VGG", "DGMESH_LPIPS_WEIGHTS",
              "DGMESH_LPIPS_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    got = TT.run_testing(fx["tcfg"], *fx["port"])
    assert not [k for k in got if "lpips" in k] and "mesh_psnr" in got


def test_pointcloud_scatter_render_matches_jax(fx, tmp_path):
    """The same points, colours and camera: the port's image (decoded by its
    own PNG reader) equals JAX's (decoded by Pillow), and the file it saves
    holds it."""
    pts = np.asarray(fx["tstate"].gp.xyz[:256].numpy(), np.float64)
    cols = np.random.default_rng(6).random((256, 3))
    jcam, tcam = fx["jax"][1].test_cameras[0], fx["port"][1].test_cameras[0]
    want = JT.pointcloud_scatter_render(pts, jcam, colors=cols)
    got = TT.pointcloud_scatter_render(pts, tcam, str(tmp_path / "pc.png"), colors=cols)
    assert got.shape == (64, 64, 3) and (got < 1).any()
    np.testing.assert_array_equal(got, want)
    from dgmesh_torch.utils_io import read_png
    np.testing.assert_array_equal(read_png(str(tmp_path / "pc.png")),
                                  (np.clip(got, 0, 1) * 255).astype(np.uint8))
