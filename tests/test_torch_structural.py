"""The port's structural ops against the JAX package's: the per-face helpers,
kNN, the occupancy grid, the surface sampler, densify/prune, the opacity
reset and the one-shot normal initialisation.

Inputs are seeded numpy arrays or the miniature JAX fixture
(tests/torch_parity_fixture.py: grid 32, 512 Gaussian slots, 256 live on a
radius-0.4 shell), carried into the port by convert.py.  jax.random cannot
be reproduced in torch, so each random op gets JAX's own draws, replayed
from the same key splits.  JAX's functions are jitted once each, in module
fixtures.  Discrete outputs (masks, indices, counts, mesh sizes) must be
equal; float outputs agree within atol 1e-5 + rtol 1e-4 unless a test
states another limit and its reason.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, jax_fixture, port_fixture, t, to_numpy

from dgmesh_torch.models import gaussians as TG
from dgmesh_torch.ops import knn as TK
from dgmesh_torch.ops import laplacian as TL
from dgmesh_torch.ops import occupancy as TO
from dgmesh_torch.train import densify as TD

from dgmesh_tpu.models import gaussians as JG
from dgmesh_tpu.ops import knn as JK
from dgmesh_tpu.ops import laplacian as JL
from dgmesh_tpu.ops import occupancy as JO
from dgmesh_tpu.ops.marching_tets import MTConfig, marching_tets
from dgmesh_tpu.train import densify as JD

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4
LEAVES = JD.PER_GAUSS


def close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def equal(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def random_mesh(rng, V=60, F=90):
    verts = rng.normal(size=(V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (F, 3)).astype(np.int32)
    valid = rng.random(F) < 0.8
    return verts, faces, valid


# --- face helpers, kNN ----------------------------------------------------------

def test_face_helpers_match_jax():
    """Normals (unit and raw), centroids and areas; invalid faces 0 on both sides."""
    verts, faces, valid = random_mesh(np.random.default_rng(0))
    jv, jf, jm = jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(valid)
    tv, tf, tm = t(verts), torch.as_tensor(faces).long(), torch.as_tensor(valid)
    close(TL.face_normals(tv, tf, tm), JL.face_normals(jv, jf, jm))
    close(TL.face_normals(tv, tf, tm, normalize=False), JL.face_normals(jv, jf, jm, False))
    close(TL.face_centroids(tv, tf, tm), JL.face_centroids(jv, jf, jm))
    close(TL.face_areas(tv, tf, tm), JL.face_areas(jv, jf, jm))
    assert not TL.face_areas(tv, tf, tm)[~tm].any()


def _gap_ok(d2, k):
    """No query's k-th and (k+1)-th distances within 1e-6 (a tie could go
    either way in float32)."""
    s = np.sort(d2, axis=1)
    return (s[:, k] - s[:, k - 1] > 1e-6).all()


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("masked,self_knn", [(False, False), (True, False), (True, True)])
def test_knn_matches_jax(k, masked, self_knn):
    """Indices exactly; squared distances within abs 1e-6 (the expansion
    ‖q‖² + ‖r‖² − 2q·r of points with ‖q‖² ≈ 1 cancels to ~1e-7 in float32,
    summed in other orders).  The seeded points have no near-tie at the
    k-th neighbour (asserted).  Queries are the refs for the self-kNN."""
    rng = np.random.default_rng(10 * k + 2 * masked + self_knn)
    refs = rng.random((300, 3)).astype(np.float32)
    q = refs if self_knn else rng.random((200, 3)).astype(np.float32)
    valid = rng.random(300) < 0.8 if masked else np.ones(300, bool)
    d_all = ((q[:, None, :].astype(np.float64) - refs[None]) ** 2).sum(-1)
    d_all[:, ~valid] = np.inf
    if self_knn:
        np.fill_diagonal(d_all, np.inf)
    assert _gap_ok(d_all, k)
    wd, wi = JK.knn(jnp.asarray(q), jnp.asarray(refs), k,
                    ref_valid=jnp.asarray(valid) if masked else None, exclude_self=self_knn,
                    q_block=64, r_block=128)
    gd, gi = TK.knn(t(q), t(refs), k, ref_valid=torch.as_tensor(valid) if masked else None,
                    exclude_self=self_knn, chunk=64)
    equal(gi, wi)
    close(gd, wd, atol=1e-6, rtol=0)


def test_mean_knn_dist2_with_valid_matches_jax():
    """Invalid points are no neighbours; the last valid point's missing
    neighbours count 0 (only two valid points here after the mask below);
    abs 1e-6 as for kNN."""
    rng = np.random.default_rng(5)
    pts = rng.random((400, 3)).astype(np.float32)
    valid = rng.random(400) < 0.7
    want = JK.mean_knn_dist2(jnp.asarray(pts), jnp.asarray(valid), k=3)
    close(TK.mean_knn_dist2(t(pts), torch.as_tensor(valid), k=3), want, atol=1e-6, rtol=0)
    few = np.zeros(400, bool)
    few[[3, 77]] = True
    want = np.asarray(JK.mean_knn_dist2(jnp.asarray(pts), jnp.asarray(few), k=3))
    got = TK.mean_knn_dist2(t(pts), torch.as_tensor(few), k=3)
    close(got, want, atol=1e-6, rtol=0)
    assert np.isfinite(want).all() and want[3] > 0


# --- the miniature state, with Gaussians broad enough for a 16³ occupancy grid ---

@pytest.fixture(scope="module")
def fx():
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=3, **ROOMY)
    rng = np.random.default_rng(0)
    gp, gs = to_numpy(state.gp), to_numpy(state.gs)
    M = gp.xyz.shape[0]
    alive = gs.alive
    # log-scales 0.1-0.3 (the shell spans a 16³ grid's iso-surface), random
    # rotations, opacities 0.002-0.9 (some below the prune threshold)
    scaling = np.where(alive[:, None], np.log(rng.uniform(0.1, 0.3, (M, 3))), gp.scaling)
    rot = rng.normal(size=(M, 4))
    opac = np.log(1 / rng.uniform(0.002, 0.9, (M, 1)) - 1) * -1
    gp = gp._replace(scaling=scaling.astype(np.float32), rotation=rot.astype(np.float32),
                     opacity=opac.astype(np.float32))
    # densify statistics: a third of the live slots over the gradient threshold
    accum = np.where(alive, rng.uniform(0, 6e-4, M), 0).astype(np.float32)
    denom = np.where(alive, rng.integers(1, 4, M), 0).astype(np.float32)
    # screen radii on every slot: a free slot's stays with it (JAX prunes a
    # clone by its slot's old radius)
    radii = rng.uniform(0, 30, M).astype(np.float32)
    gs = gs._replace(xyz_grad_accum=accum, denom=denom, max_radii2d=radii)
    mu = type(gp)(*[rng.normal(size=x.shape).astype(np.float32) for x in gp])
    nu = type(gp)(*[rng.random(x.shape).astype(np.float32) for x in gp])
    state = state._replace(gp=jax.tree.map(jnp.asarray, gp), gs=jax.tree.map(jnp.asarray, gs),
                           g_mu=jax.tree.map(jnp.asarray, mu), g_nu=jax.tree.map(jnp.asarray, nu))
    tcfg, tctx, tstate, tbatch = port_fixture(cfg, img, state)
    return SimpleNamespace(cfg=cfg, ctx=ctx, state=state, batch=batch, tcfg=tcfg,
                           tstate=tstate, tbatch=tbatch)


OCC = dict(center=(0.0, 0.0, 0.0), half=2.0, res=16)


def _occ_inputs(gp, gs, Gm):
    return (gp.xyz, Gm.get_scaling(gp), Gm.get_rotation(gp), Gm.get_opacity(gp), gs.alive)


@pytest.fixture(scope="module")
def occ(fx):
    """JAX's occupancy grid of the state, its iso-surface at 0.01 and the
    surface sampler's draws and output."""
    st = fx.state
    grid = jax.jit(lambda gp, gs: JO.gaussian_occupancy_grid(
        *_occ_inputs(gp, gs, JG), jnp.zeros(3), OCC["half"], OCC["res"]))(st.gp, st.gs)
    m = jax.jit(lambda g: marching_tets(0.01 - g, MTConfig(res=16, max_verts=4096,
                                                           max_faces=8192, max_cubes=4096)))(grid)
    verts_w = m.verts * 2.0 * OCC["half"] - OCC["half"]
    key = jax.random.PRNGKey(11)
    pts, nrm = JO.sample_mesh_surface(key, verts_w, m.faces, m.face_valid, 300)
    k1, k2 = jax.random.split(key)
    u, uv = jax.random.uniform(k1, (300,)), jax.random.uniform(k2, (300, 2))
    return SimpleNamespace(grid=np.asarray(grid), m=to_numpy(m), verts_w=np.asarray(verts_w),
                           pts=np.asarray(pts), nrm=np.asarray(nrm), u=t(u), uv=t(uv))


def test_occupancy_grid_matches_jax(fx, occ):
    """The bricked, culled sum against JAX's every-pair sum at res 16 and at
    another center and extent at res 12 (a ragged last brick): the same
    terms in another order."""
    st = fx.tstate
    got = TO.gaussian_occupancy_grid(*_occ_inputs(st.gp, st.gs, TG), torch.zeros(3),
                                     OCC["half"], OCC["res"])
    assert float(occ.grid.max()) > 0.05 and (occ.grid > 0.01).mean() > 0.02
    close(got, occ.grid)
    want = JO.gaussian_occupancy_grid(*_occ_inputs(fx.state.gp, fx.state.gs, JG),
                                      jnp.asarray([0.1, -0.2, 0.05]), 0.7, 12)
    got = TO.gaussian_occupancy_grid(*_occ_inputs(st.gp, st.gs, TG),
                                     torch.tensor([0.1, -0.2, 0.05]), 0.7, 12)
    close(got, want)


def test_sample_mesh_surface_matches_jax(occ):
    """JAX's draws injected: the same faces (so the same normals) and points."""
    m = occ.m
    assert int(m.n_faces) > 100
    pts, nrm = TO.sample_mesh_surface(t(occ.verts_w), torch.as_tensor(np.array(m.faces)).long(),
                                      torch.as_tensor(np.array(m.face_valid)), 300, u=occ.u, uv=occ.uv)
    close(nrm, occ.nrm)
    close(pts, occ.pts)


# --- densify / prune and the opacity reset --------------------------------------

EXTENT = 1.5     # percent_dense · extent = 0.015: every hit Gaussian splits


@pytest.fixture(scope="module", params=[False, True], ids=["no size", "use size"])
def densified(fx, request):
    use_size = request.param
    st = fx.state
    # half the live Gaussians small enough to clone
    gp = st.gp._replace(scaling=jnp.where(jnp.arange(512)[:, None] % 2 == 0,
                                          jnp.log(0.005), st.gp.scaling))
    key = jax.random.PRNGKey(21)
    out = jax.jit(lambda gp, gs, mu, nu: JD.densify_and_prune(
        fx.cfg, gp, gs, mu, nu, jnp.float32(EXTENT), key, use_size))(gp, st.gs, st.g_mu, st.g_nu)
    k1, k2 = jax.random.split(key)
    draws = [t(jax.random.normal(k, (512, 3))) for k in (k1, k2)]
    ts = fx.tstate
    tgp = ts.gp._replace(scaling=t(gp.scaling))
    before = [x.clone() for x in tgp]
    got = TD.densify_and_prune(fx.tcfg, tgp, ts.gs, ts.g_mu, ts.g_nu, EXTENT, use_size,
                               split_normals=draws)
    assert all(torch.equal(a, b) for a, b in zip(before, tgp))     # inputs untouched
    return SimpleNamespace(want=to_numpy(out), got=got, pre_alive=np.asarray(st.gs.alive))


def test_densify_and_prune_matches_jax(densified):
    """Clone, split and prune all fire; alive exactly, every per-Gaussian
    leaf and both moments (zero on every touched slot), and the statistics
    reset."""
    (wgp, wgs, wmu, wnu), (tgp, tgs, tmu, tnu, counts) = densified.want, densified.got
    assert int(counts["clone"]) > 10 and int(counts["split"]) > 10 and int(counts["prune"]) > 0
    equal(tgs.alive, wgs.alive)
    for n in LEAVES:
        close(getattr(tgp, n), getattr(wgp, n), msg=n)
        close(getattr(tmu, n), getattr(wmu, n), msg=n)
        close(getattr(tnu, n), getattr(wnu, n), msg=n)
    for n in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(tgs, n).any()
    # the counts: every split slot and clone destination has zero moments
    zero = ~np.asarray(wmu.xyz).any(-1)
    assert zero.sum() >= int(counts["clone"]) + 2 * int(counts["split"])


def test_reset_opacity_matches_jax(fx):
    st, ts = fx.state, fx.tstate
    wgp, wmu, wnu = JD.reset_opacity(st.gp, st.g_mu, st.g_nu)
    gp, mu, nu = TD.reset_opacity(ts.gp, ts.g_mu, ts.g_nu)
    close(gp.opacity, wgp.opacity)
    assert float(TG.get_opacity(gp).max()) <= 0.01 + 1e-6
    assert not mu.opacity.any() and not nu.opacity.any()
    equal(mu.xyz, wmu.xyz)


# --- the one-shot normal initialisation -----------------------------------------

def test_normal_initialization_matches_jax(fx):
    """occ_res 16, the nets in float32, JAX's sampler draws: the mesh's size
    and faces exactly, its vertices, and every live Gaussian's normal (0 on
    dead slots); density_thres reset.  A normal is its nearest sample's face
    normal: the seeded state has no near-tie between a Gaussian's two
    nearest samples (asserted).  Normals to abs 1e-4: each is a face's
    normalised edge cross product, and the vertices differ by ~1e-6 (the
    occupancy summed in another order, through the edge interpolation
    φ0 / (φ0 − φ1)), which turns the normals of the smallest faces by up to
    1.6e-5 here."""
    st, ts = fx.state, fx.tstate
    cfg = fx.cfg
    key = jax.random.PRNGKey(5)
    gp, m = jax.jit(lambda gp, gs, nets, fid: JD.normal_initialization(
        cfg, fx.ctx.f32().nets_def, gp, gs, nets, fid, key, occ_res=16))(
            st.gp, st.gs, st.nets, fx.batch.fid)
    k1, k2 = jax.random.split(key)
    M = st.gp.xyz.shape[0]
    u, uv = t(jax.random.uniform(k1, (M,))), t(jax.random.uniform(k2, (M, 2)))
    tgp, tm = TD.normal_initialization(fx.tcfg, ts.gp, ts.gs, ts.nets, fx.tbatch.fid,
                                       occ_res=16, u=u, uv=uv)
    assert int(m.n_faces) > 100 and int(m.overflow) == 0
    for k in ("n_verts", "n_faces", "overflow"):
        assert int(getattr(tm, k)) == int(getattr(m, k)), k
    close(tm.verts, m.verts)
    equal(tm.faces, m.faces)
    alive = np.asarray(st.gs.alive)
    assert not tgp.normal.numpy()[~alive].any()
    with torch.no_grad():
        d_xyz = ts.nets.deform(ts.gp.xyz, fx.tbatch.fid.reshape(1, 1).expand(M, 1), "f32")[0]
    samp, _ = TO.sample_mesh_surface(tm.verts * 4.0 - 2.0, tm.faces, tm.face_valid, M,
                                     u=u, uv=uv)
    d2, _ = TK.knn(ts.gp.xyz + d_xyz, samp, 2)
    assert (d2[:, 1] - d2[:, 0]).numpy()[alive].min() > 1e-6
    close(tgp.normal, gp.normal, atol=1e-4)
    assert float(tgp.density_thres) == float(gp.density_thres)
