"""The port's ops and networks against the JAX package, module by module.

Inputs come from the miniature JAX fixture (tests/torch_parity_fixture.py)
or from numpy with a seed, and go through both packages.  Each tolerance is
stated with its reason.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOT, jax_fixture, port_fixture, t, to_numpy

from dgmesh_torch import cameras as TCam
from dgmesh_torch import config as TConfig
from dgmesh_torch.models import gaussians as TG
from dgmesh_torch.ops import binning as TB
from dgmesh_torch.ops import dpsr as TD
from dgmesh_torch.ops import knn as TK
from dgmesh_torch.ops import marching_tets as TMT
from dgmesh_torch.ops import mesh_raster as TMR
from dgmesh_torch.ops import splat as TS
from dgmesh_torch.train import step as TStep

from dgmesh_tpu import cameras as JCam
from dgmesh_tpu import config as JConfig
from dgmesh_tpu.models import gaussians as JG
from dgmesh_tpu.ops import binning as JB
from dgmesh_tpu.ops import dpsr as JD
from dgmesh_tpu.ops import knn as JK
from dgmesh_tpu.ops import marching_tets as JMT
from dgmesh_tpu.ops import mesh_raster as JMR
from dgmesh_tpu.ops import splat as JS
from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fx():
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3)
    tcfg, tctx, tstate, tbatch = port_fixture(cfg, img, state)
    flags = JStep.StepFlags(mesh=True, use_normal=True, sh_degree=1)
    d = jax.jit(lambda st, b: JStep._deform_all(ctx, st.nets, st.gp.xyz, b.fid, 0.0,
                                                flags))(state, batch)
    mesh = jax.jit(lambda st, d: JStep.extract_mesh(ctx, st.gp, st.gs, d[0], d[3],
                                                    freeze_pos=False))(state, d)
    return dict(cfg=cfg, img=img, ctx=ctx, state=state, batch=batch, tcfg=tcfg,
                tctx=tctx, tstate=tstate, tbatch=tbatch, d=to_numpy(d),
                mesh=to_numpy(mesh))


# --- host side: config and cameras (exact) ----------------------------------

CONFIGS = sorted(glob.glob(os.path.join(str(ROOT), "configs", "*.yaml")))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_loads_like_jax(path):
    import argparse
    a = JConfig.config_from_args(argparse.Namespace(), path).to_dict()
    b = TConfig.config_from_args(argparse.Namespace(), path).to_dict()
    a["model"].pop("data_device")
    b["model"].pop("data_device")
    assert a == b
    assert [f.name for f in dataclasses.fields(TConfig.TpuParams)] == \
        [f.name for f in dataclasses.fields(JConfig.TpuParams)]


def test_cameras_match_jax():
    poses = JCam.orbit_camera_poses(3, radius=2.5, elevation=0.35)
    np.testing.assert_array_equal(poses, TCam.orbit_camera_poses(3, radius=2.5, elevation=0.35))
    for i, c2w in enumerate(poses):
        a = JCam.camera_from_c2w_blender(i, c2w, 0.8, 96, 64, 0.5)
        b = TCam.camera_from_c2w_blender(i, c2w, 0.8, 96, 64, 0.5)
        for name in ("world_view", "full_proj", "camera_center", "intrinsics"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        np.testing.assert_array_equal(a.mesh_pose(), b.mesh_pose())
        np.testing.assert_array_equal(JCam.gl_projection_from_K(a.intrinsics, 96, 64),
                                      TCam.gl_projection_from_K(b.intrinsics, 96, 64))


# --- Gaussians: init, kNN, activations --------------------------------------

def test_init_state_gaussians_match_jax(fx):
    """create_from_pcd + update_scale_center: abs 1e-5 (the kNN distance
    expansion sums in another order, then log(sqrt(·)) of it)."""
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 0.3, (300, 3)).astype(np.float32)
    cols = rng.random((300, 3)).astype(np.float32)
    jgp, jgs = JG.create_from_pcd(pts, cols, 384, init_density_threshold=0.05)
    jgs = JG.update_scale_center(jgp, jgs, 1.5)
    tgp, tgs = TG.create_from_pcd(pts, cols, 384, init_density_threshold=0.05, device="cpu")
    tgs = TG.update_scale_center(tgp, tgs, 1.5)
    for name in TG.GaussianParams._fields:
        np.testing.assert_allclose(getattr(tgp, name).numpy(), np.asarray(getattr(jgp, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
    for name in ("alive", "gaussian_center", "gaussian_scale"):
        np.testing.assert_allclose(getattr(tgs, name).numpy(), np.asarray(getattr(jgs, name)),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_mean_knn_dist2_matches_jax():
    """Exact kNN both sides; abs 1e-6: the expansion ‖q‖²+‖r‖²−2q·r of
    points with ‖q‖² ≈ 1 cancels to ~1e-7 in float32, summed in other orders."""
    rng = np.random.default_rng(1)
    pts = rng.random((700, 3)).astype(np.float32)
    valid = rng.random(700) < 0.9
    want = np.asarray(JK.mean_knn_dist2(jnp.asarray(pts), jnp.asarray(valid)))[valid]
    got = TK.mean_knn_dist2(t(pts)[t(valid, torch.bool)], chunk=256).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- splat: preprocess and binning ------------------------------------------

def _splat_inputs(fx):
    gp, gs = fx["state"].gp, fx["state"].gs
    d_xyz, d_rot, d_scale, _ = fx["d"]
    return (np.asarray(gp.xyz) + d_xyz, np.asarray(JG.get_scaling(gp)) + d_scale,
            np.asarray(JG.get_rotation(gp)) + d_rot, np.asarray(JG.get_opacity(gp)),
            np.asarray(JG.get_features(gp)), np.asarray(gs.alive))


def test_preprocess_matches_jax(fx):
    """abs/rel 1e-5: 4-term f32 dot products summed in another order; the
    integer radius and the valid mask exactly."""
    args = _splat_inputs(fx)
    want = jax.jit(lambda *a: JS.preprocess(*a, fx["ctx"].splat_cfg, 1))(
        *map(jnp.asarray, args), fx["batch"].cam)
    targs = [t(a, torch.bool if a.dtype == bool else torch.float32) for a in args]
    got = TS.preprocess(*targs, fx["tbatch"].cam, fx["tctx"].splat_cfg, 1)
    assert int(got["valid"].sum()) > 100
    for k in ("mean2d", "depth", "conic", "color", "opacity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_array_equal(got["radius"].numpy(), np.asarray(want["radius"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))


@pytest.mark.parametrize("max_per_tile,max_dup", [(64, 1 << 12), (8, 300)])
def test_bin_gaussians_matches_jax(fx, max_per_tile, max_dup):
    """The same screen-space Gaussians binned by both packages: the per-tile
    lists and every counter exact (also with K and max_dup truncating)."""
    args = _splat_inputs(fx)
    cfg = fx["ctx"].splat_cfg._replace(max_per_tile=max_per_tile, max_dup=max_dup)
    pre = to_numpy(jax.jit(lambda *a: JS.preprocess(*a, cfg, 1))(
        *map(jnp.asarray, args), fx["batch"].cam))
    want_idx, want_aux = jax.jit(lambda p: JS.bin_gaussians(p, cfg))(
        {k: jnp.asarray(v) for k, v in pre.items()})
    tcfg = TS.SplatConfig(cfg.width, cfg.height, cfg.tile_h, cfg.tile_w, max_per_tile, max_dup)
    tpre = {k: t(v, torch.bool if v.dtype == bool else torch.float32) for k, v in pre.items()}
    got_idx, got_aux = TS.bin_gaussians(tpre, tcfg)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for k in ("num_duplicates", "dup_overflow", "tile_overflow"):
        assert int(got_aux[k]) == int(want_aux[k]), k
    if max_per_tile == 8:
        assert int(got_aux["tile_overflow"]) > 0 and int(got_aux["dup_overflow"]) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_rects_random_matches_jax(seed):
    """Random rects, keys with depth ties, invalid items: exact."""
    rng = np.random.default_rng(seed)
    n, tx, ty = 400, 9, 7
    tx0 = rng.integers(0, tx, n).astype(np.int32)
    ty0 = rng.integers(0, ty, n).astype(np.int32)
    nx = np.minimum(rng.integers(0, 4, n), tx - tx0).astype(np.int32)
    ny = np.minimum(rng.integers(0, 4, n), ty - ty0).astype(np.int32)
    depth = rng.integers(0, 1 << 8, n).astype(np.float32)     # many exact ties
    valid = rng.random(n) < 0.8
    key_j = JB.quantize_depth(jnp.asarray(depth), jnp.asarray(valid))
    key_t = TB.quantize_depth(t(depth), t(valid, torch.bool))
    np.testing.assert_array_equal(key_t.numpy()[valid], np.asarray(key_j)[valid])
    for K, dup in ((16, 4096), (5, 900)):
        want = jax.jit(lambda *a: JB.bin_rects(*a, tiles_x=tx, tiles_y=ty, max_dup=dup,
                                               max_per_tile=K))(
            *map(jnp.asarray, (tx0, ty0, nx, ny)), key_j, jnp.asarray(valid))
        got = TB.bin_rects(*(t(a, torch.int32) for a in (tx0, ty0, nx, ny)), key_t,
                           t(valid, torch.bool), tiles_x=tx, tiles_y=ty, max_dup=dup,
                           max_per_tile=K)
        np.testing.assert_array_equal(got.tile_idx.numpy(), np.asarray(want.tile_idx))
        np.testing.assert_array_equal(got.tile_count.numpy(), np.asarray(want.tile_count))
        for k in ("num_duplicates", "dup_overflow", "tile_overflow"):
            assert int(getattr(got, k)) == int(getattr(want, k)), k


# --- mesh raster binning ----------------------------------------------------

@pytest.mark.parametrize("cull", [False, True])
def test_mesh_rasterize_bins_match_jax(fx, cull):
    """The JAX mesh of the fixture binned by both packages: tile lists and
    counters exact; the packed screen rows abs 1e-4 px (f32 projection)."""
    m = fx["mesh"]
    b = fx["batch"]
    cfg = fx["ctx"].mr_cfg._replace(cull_backface=cull)
    want = jax.jit(lambda *a: JMR.rasterize(*a, cfg))(
        jnp.asarray(m.verts), jnp.asarray(m.faces), jnp.asarray(m.face_valid),
        b.mesh_pose, b.mesh_proj)
    tcfg = fx["tctx"].mr_cfg._replace(cull_backface=cull)
    got = TMR.rasterize(t(m.verts), t(m.faces, torch.long), t(m.face_valid, torch.bool),
                        fx["tbatch"].mesh_pose, fx["tbatch"].mesh_proj, tcfg)
    assert int(m.n_faces) > 100
    np.testing.assert_array_equal(got["fvalid"].numpy(), np.asarray(want["fvalid"]))
    np.testing.assert_array_equal(got["bins"].tile_idx.numpy(),
                                  np.asarray(want["bins"].tile_idx))
    for k in ("num_duplicates", "dup_overflow", "tile_overflow"):
        assert int(getattr(got["bins"], k)) == int(getattr(want["bins"], k)), k
    np.testing.assert_allclose(got["pack"].numpy(), np.asarray(want["pack"]), rtol=0, atol=1e-4)


# --- DPSR and marching tets -------------------------------------------------

def _dpsr_inputs(fx):
    gp, gs = fx["state"].gp, fx["state"].gs
    d_xyz, d_normal = fx["d"][0], fx["d"][3]
    pts = np.asarray(gp.xyz) + d_xyz
    p01 = (pts - np.asarray(gs.gaussian_center)) / np.asarray(gs.gaussian_scale) / 2.0 + 0.5
    return (np.clip(p01, 1e-6, 1 - 1e-6).astype(np.float32),
            (np.asarray(gp.normal) + d_normal).astype(np.float32), np.asarray(gs.alive))


@pytest.mark.parametrize("div_mode,fft_impl", [("spectral", "xla"), ("splat", "xla"),
                                               ("splat", "matmul")])
def test_dpsr_matches_jax(fx, div_mode, fft_impl):
    """φ within abs 1e-5·max|φ|: index_add_ against slab matmuls and
    torch.fft against XLA's FFT or the matmul DFT sum in other orders."""
    p01, normals, alive = _dpsr_inputs(fx)
    res = (32, 32, 32)
    want = np.asarray(JD.DPSR(res, sig=2.0, div_mode=div_mode, fft_impl=fft_impl)(
        jnp.asarray(p01), jnp.asarray(normals), jnp.asarray(alive)))
    got = TD.DPSR(res, sig=2.0, div_mode=div_mode, device="cpu")(
        t(p01), t(normals), t(alive, torch.bool)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert (want < 0).any() and (want > 0).any()


def test_mt_tables_equal_jax():
    np.testing.assert_array_equal(TMT._TRI_TABLE_NP, JMT._TRI_TABLE_NP)
    np.testing.assert_array_equal(TMT._TRI_COUNT_NP, JMT._TRI_COUNT_NP)
    np.testing.assert_array_equal(TMT._EDGE_ANCHOR_NP, JMT._EDGE_ANCHOR_NP)
    np.testing.assert_array_equal(TMT._EDGE_CLASS_NP, JMT._EDGE_CLASS_NP)


@pytest.mark.parametrize("max_verts,max_faces", [(4096, 8192), (600, 900)])
def test_marching_tets_matches_jax(fx, max_verts, max_faces):
    """The same φ through both: V, F, faces, validity and the overflow
    counter exact (also when the caps truncate); verts abs 1e-6."""
    p01, normals, alive = _dpsr_inputs(fx)
    phi = np.asarray(JD.DPSR((32,) * 3, sig=2.0)(jnp.asarray(p01), jnp.asarray(normals),
                                                 jnp.asarray(alive))) - 0.05
    cfg = JMT.MTConfig(res=32, max_verts=max_verts, max_faces=max_faces,
                       max_cubes=max(max_verts, max_faces // 2))
    want = to_numpy(jax.jit(lambda p: JMT.marching_tets(p, cfg))(jnp.asarray(phi)))
    got = TMT.marching_tets(t(phi), TMT.MTConfig(32, max_verts, max_faces, cfg.max_cubes))
    for k in ("n_verts", "n_faces", "overflow"):
        assert int(getattr(got, k)) == int(getattr(want, k)), k
    np.testing.assert_array_equal(got.faces.numpy(), want.faces)
    np.testing.assert_array_equal(got.vert_valid.numpy(), want.vert_valid)
    np.testing.assert_array_equal(got.face_valid.numpy(), want.face_valid)
    np.testing.assert_allclose(got.verts.numpy(), want.verts, rtol=0, atol=1e-6)
    assert int(want.n_faces) > 100
    if max_verts == 600:
        assert int(want.overflow) > 0


# --- networks through convert.py --------------------------------------------

NETS = ["deform", "deform_normal", "deform_back", "deform_back_normal", "appearance"]


@pytest.mark.parametrize("name", NETS)
def test_networks_match_jax(fx, name):
    """Flax params (with noise on the zero-init heads) carried across by
    convert.py: every output abs 1e-5 (f32 matmuls summed in other orders)."""
    from dgmesh_tpu.train.state import build_nets
    rng = np.random.default_rng(2)
    xyz = rng.normal(0, 0.4, (257, 3)).astype(np.float32)
    tt = np.full((257, 1), 0.3, np.float32)
    jnet = getattr(build_nets(fx["cfg"]), name)
    want = jnet.apply(getattr(fx["state"].nets, name), jnp.asarray(xyz), jnp.asarray(tt))
    want = want if isinstance(want, tuple) else (want,)
    with torch.no_grad():
        got = getattr(fx["tstate"].nets, name)(t(xyz), t(tt))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
        assert np.abs(np.asarray(w)).max() > 1e-4          # heads are not zero


def test_positional_encoding_matches_jax():
    from dgmesh_tpu.models.mlp import positional_encoding as jpe
    from dgmesh_torch.models.mlp import positional_encoding as tpe
    x = np.random.default_rng(4).normal(size=(33, 3)).astype(np.float32)
    np.testing.assert_allclose(tpe(t(x), 10).numpy(), np.asarray(jpe(jnp.asarray(x), 10)),
                               rtol=0, atol=1e-6)


def test_extract_mesh_matches_jax(fx):
    """DPSR → sign fix → density_thres → marching tets → world frame: V, F
    and faces exact; verts abs 1e-5 (the two DPSRs' φ differ at ~1e-7
    relative, which moves the edge interpolation t)."""
    tgp, tgs = fx["tstate"].gp, fx["tstate"].gs
    m = TStep.extract_mesh(fx["tctx"], tgp, tgs, t(fx["d"][0]), t(fx["d"][3]))
    want = fx["mesh"]
    assert int(m.n_verts) == int(want.n_verts) and int(m.n_faces) == int(want.n_faces)
    np.testing.assert_array_equal(m.faces.numpy(), want.faces)
    np.testing.assert_allclose(m.verts.numpy(), want.verts, rtol=0, atol=1e-5)
