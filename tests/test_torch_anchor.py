"""The port's mesh anchoring against the JAX package's: ``anchor_step``, the
anchor term of the loss and its gradients, the phase flags, and
``run_iteration``'s anchor-iteration semantics.

The state is the miniature JAX fixture (tests/torch_parity_fixture.py: grid
32, 512 slots, 256 live on a radius-0.4 shell, ROOMY mesh caps) with 55
extra Gaussians within 1e-3 of 35 live ones (so that faces hold 2, 3 and 4
Gaussians) and seeded Adam moments (so that zeroed moments show).  Both
sides anchor to one mesh, the port's float32 extraction with frozen
positions, and get JAX's draws, replayed from the same key splits.  JAX's
functions are jitted once per configuration, in module fixtures.  Discrete
outputs (alive, the 1-1 mask, the counters) must be equal: the fixture
has no live Gaussian whose JAX d² lies within 1e-6 of the radius and no
two nearest centroids whose d² are within 1e-7 (asserted; both sides'
d² carry the expansion's rounding, a few ulp of ‖q‖² ≈ 0.16, ~1e-8), so
a mismatch is a bug, not a boundary row.  Float outputs agree within atol 1e-5 + rtol 1e-4 unless a
test states another limit and its reason.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, jax_fixture, port_batch, port_fixture, t, to_numpy

from dgmesh_torch import config as TConfig
from dgmesh_torch import convert
from dgmesh_torch.train import densify as TD
from dgmesh_torch.train import loop as TLoop
from dgmesh_torch.train import step as TStep

from dgmesh_tpu import config as JConfig
from dgmesh_tpu.ops import knn as JK
from dgmesh_tpu.ops import laplacian as JL
from dgmesh_tpu.train import densify as JD
from dgmesh_tpu.train import loop as JLoop
from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4


def close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def clustered(state, rng):
    """Copies of live Gaussians 0-34 in dead slots 256-310, each moved by
    N(0, 1e-3): 20 pairs, 10 triples, 5 quadruples; and seeded moments."""
    gp, gs = to_numpy(state.gp), to_numpy(state.gs)
    src = (list(range(20)) + [i for i in range(20, 30) for _ in range(2)]
           + [i for i in range(30, 35) for _ in range(3)])
    dst = 256 + np.arange(len(src))
    leaves = {}
    for n in JD.PER_GAUSS:
        a = np.array(getattr(gp, n))
        a[dst] = a[src]
        leaves[n] = a
    leaves["xyz"][dst] += rng.normal(0, 1e-3, (len(src), 3)).astype(np.float32)
    alive = np.array(gs.alive)
    alive[dst] = True
    gp = gp._replace(**leaves)
    mu = type(gp)(*[rng.normal(size=x.shape).astype(np.float32) for x in gp])
    nu = type(gp)(*[rng.random(x.shape).astype(np.float32) for x in gp])
    j = lambda tree: jax.tree.map(jnp.asarray, tree)  # noqa: E731
    return state._replace(gp=j(gp), gs=j(gs._replace(alive=alive)), g_mu=j(mu), g_nu=j(nu))


@pytest.fixture(scope="module")
def fx():
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=7, **ROOMY)
    state = clustered(state, np.random.default_rng(1))
    tcfg, tctx, tstate, _ = port_fixture(cfg, img, state)
    tbatch = port_batch(batch)
    with torch.no_grad():
        d_xyz, _, _, d_n = TStep._deform_all(tstate.nets, tstate.gp.xyz, tbatch.fid, True,
                                             mode="f32")
        mesh = TStep.extract_mesh(tctx, tstate.gp, tstate.gs, d_xyz, d_n, freeze_pos=True)
    jm = tuple(jnp.asarray(np.array(x)) for x in (mesh.verts, mesh.faces.int(), mesh.face_valid))
    cf = ctx.f32()
    M = state.gp.xyz.shape[0]
    gpts = jax.jit(lambda st, fid: st.gp.xyz + cf.nets_def.deform.apply(
        st.nets.deform, st.gp.xyz, jnp.full((M, 1), fid))[0])(state, batch.fid)
    cent = JL.face_centroids(*jm)
    d2, nn = JK.knn(gpts, cent, 2, ref_valid=jm[2])
    return SimpleNamespace(cfg=cfg, img=img, ctx=ctx, state=state, batch=batch, tcfg=tcfg,
                           tctx=tctx, tstate=tstate, tbatch=tbatch, mesh=mesh, jmesh=jm,
                           d2=np.asarray(d2), nn=np.asarray(nn),
                           alive=np.asarray(state.gs.alive))


CASES = {  # topn, anchor_n_1_bs, anchor_0_1_bs, anchor_search_radius
    # more n-1 faces than the batch; radius pruning
    "topn 2": (2, 8, 64, 5e-4),
    # a wide radius keeps the clusters: faces of 2 (< topn, averaged), 3 and 4
    "topn 3": (3, 64, 64, 2e-3),
    # fewer n-1 faces than the batch, fewer free slots than spawns
    "few candidates and slots": (2, 512, 512, 5e-4),
}


def case_cfgs(fx, name):
    topn, n1, n01, radius = CASES[name]
    cfgs = []
    for c in (fx.cfg, fx.tcfg):
        c = type(c).from_dict(c.to_dict())
        o = c.optimization
        o.anchor_topn, o.anchor_n_1_bs, o.anchor_0_1_bs, o.anchor_search_radius = (
            topn, n1, n01, radius)
        cfgs.append(c)
    return cfgs


@pytest.fixture(scope="module", params=list(CASES))
def anchored(fx, request):
    name = request.param
    jcfg, tcfg = case_cfgs(fx, name)
    st = fx.state
    key = jax.random.PRNGKey(3)
    cf = fx.ctx.f32()
    want = jax.jit(lambda st, fid, v, f, fv: JD.anchor_step(
        jcfg, cf.nets_def, st.gp, st.gs, st.g_mu, st.g_nu, st.nets, fid, v, f, fv, key))(
            st, fx.batch.fid, *fx.jmesh)
    k1, k2, k3 = jax.random.split(key, 3)
    F = fx.mesh.faces.shape[0]
    draws = {"n_1": t(jax.random.uniform(k1, (F,))), "0_1": t(jax.random.uniform(k2, (F,))),
             "angle": t(jax.random.normal(k3, (jcfg.optimization.anchor_0_1_bs, 1)))}
    ts = fx.tstate
    before = [x.clone() for x in ts.gp] + [ts.gs.alive.clone()]
    got = TD.anchor_step(tcfg, ts.gp, ts.gs, ts.g_mu, ts.g_nu, ts.nets, fx.tbatch.fid,
                         fx.mesh.verts, fx.mesh.faces, fx.mesh.face_valid, draws=draws)
    assert all(torch.equal(a, b) for a, b in zip(before, list(ts.gp) + [ts.gs.alive]))
    radius = float(st.gs.gaussian_scale) * jcfg.optimization.anchor_search_radius
    return SimpleNamespace(name=name, want=want, got=got, draws=draws, cfg=jcfg, tcfg=tcfg,
                           radius=radius)


def test_fixture_has_no_boundary_rows(fx, anchored):
    """No live Gaussian's d² within 1e-6 of the radius, nor its two
    nearest centroids' d² within 1e-7 of each other (JAX's distances; the
    closest pair here is 4.8e-7 apart)."""
    live = fx.alive
    assert np.abs(fx.d2[live, 0] - anchored.radius).min() > 1e-6
    assert (fx.d2[live, 1] - fx.d2[live, 0]).min() > 1e-7


def test_anchor_step_matches_jax(fx, anchored):
    """Alive, the 1-1 mask and every counter exactly; the nearest centroids,
    the n-1 term, every per-Gaussian leaf and both moments (zero on every
    touched slot); the statistics reset."""
    wgp, wgs, wmu, wnu, winfo = anchored.want
    tgp, tgs, tmu, tnu, tinfo = anchored.got
    np.testing.assert_array_equal(tgs.alive.numpy(), np.asarray(wgs.alive))
    np.testing.assert_array_equal(tinfo.gauss_1_1_mask.numpy(), np.asarray(winfo.gauss_1_1_mask))
    for k, v in winfo.stats.items():
        assert int(tinfo.stats[k]) == int(v), k
    close(tinfo.centroid_of_gaussian, winfo.centroid_of_gaussian)
    close(tinfo.loss_n_1, winfo.loss_n_1)
    for n in JD.PER_GAUSS:
        close(getattr(tgp, n), getattr(wgp, n), msg=n)
        close(getattr(tmu, n), getattr(wmu, n), msg=n)
        close(getattr(tnu, n), getattr(wnu, n), msg=n)
    for n in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(tgs, n).any()


def test_anchor_cases_cover_their_branches(fx, anchored):
    """Each case reaches what it is for (counts from JAX's distances)."""
    o = anchored.cfg.optimization
    stats = {k: int(v) for k, v in anchored.want[4].stats.items()}
    alive1 = fx.alive & (fx.d2[:, 0] < anchored.radius)
    counts = np.bincount(fx.nn[alive1, 0], minlength=fx.mesh.faces.shape[0])
    n_cn, free = int((counts > 1).sum()), 512 - int(alive1.sum())
    assert stats["n_merged"] == min(n_cn, o.anchor_n_1_bs) and stats["n_spawned"] > 0
    if anchored.name == "topn 2":
        assert n_cn > o.anchor_n_1_bs and stats["n_pruned_radius"] > 0
    elif anchored.name == "topn 3":
        assert n_cn < o.anchor_n_1_bs and (counts == 2).any() and (counts > 3).any()
    else:
        assert n_cn < o.anchor_n_1_bs and stats["n_spawned"] < o.anchor_0_1_bs
        assert stats["n_alive_after"] == 512 and free < o.anchor_0_1_bs


# --- the anchor loss and its gradients ----------------------------------------

JFLAGS = dict(mesh=False, use_normal=True, sh_degree=1, skip_gaussian_update=True)


@pytest.fixture(scope="module")
def anchor_grads(fx):
    """JAX's loss and gradients with the anchor term and without it (one
    compile each), from the "topn 2" case's anchor info; the port's the same
    way from its own anchor step."""
    jcfg, tcfg = case_cfgs(fx, "topn 2")
    st, key = fx.state, jax.random.PRNGKey(3)
    cf = fx.ctx.f32()
    info = jax.jit(lambda st, fid, v, f, fv: JD.anchor_step(
        jcfg, cf.nets_def, st.gp, st.gs, st.g_mu, st.g_nu, st.nets, fid, v, f, fv, key))(
            st, fx.batch.fid, *fx.jmesh)[4]
    M = st.gp.xyz.shape[0]
    out = {}
    for anchor in (True, False):
        flags = JStep.StepFlags(anchor=anchor, **JFLAGS)

        def lg(gp, nets, so):
            return JStep.loss_and_aux(fx.ctx, gp, nets, so, st.gs, fx.batch, key,
                                      jnp.asarray(9000.0), flags, info._asdict())
        (loss, aux), grads = jax.jit(jax.value_and_grad(lg, argnums=(0, 1, 2), has_aux=True))(
            st.gp, st.nets, jnp.zeros((M, 2)))
        out[anchor] = (float(loss), to_numpy(aux["losses"]), to_numpy(grads))
    k1, k2, k3 = jax.random.split(key, 3)
    F = fx.mesh.faces.shape[0]
    draws = {"n_1": t(jax.random.uniform(k1, (F,))), "0_1": t(jax.random.uniform(k2, (F,))),
             "angle": t(jax.random.normal(k3, (jcfg.optimization.anchor_0_1_bs, 1)))}
    ts = fx.tstate
    tinfo = TD.anchor_step(tcfg, ts.gp, ts.gs, ts.g_mu, ts.g_nu, ts.nets, fx.tbatch.fid,
                           fx.mesh.verts, fx.mesh.faces, fx.mesh.face_valid, draws=draws)[4]
    ts = ts._replace(step=torch.tensor(9000, dtype=torch.int32))
    tout = {}
    for anchor in (True, False):
        flags = TStep.StepFlags(anchor=anchor, **JFLAGS)
        loss, aux, grads = TStep.loss_and_grads(fx.tctx, ts, fx.tbatch, flags, anchor_info=tinfo)
        tout[anchor] = (float(loss), aux["losses"], grads)
    return out, tout


def test_anchor_loss_matches_jax(anchor_grads):
    """The anchor term and the total, rel 1e-5 (float32 sums in other orders)."""
    out, tout = anchor_grads
    want, got = out[True][1], tout[True][1]
    assert float(want["anchor_loss"]) > 0 and "anchor_loss" not in tout[False][1]
    for k in ("anchor_loss", "img_loss", "cycle_loss"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    assert abs(tout[True][0] - out[True][0]) <= 1e-5 * abs(out[True][0])


def test_anchor_term_gradients_match_jax(fx, anchor_grads):
    """The anchor term's own gradient (the step's with it minus without it)
    into the Gaussian positions and into the deform net's leaves: rel 1e-3
    of the leaf's largest value.  The 1-1 term's gradient through
    means3d = xyz + deform(xyz) is 0.2 (means3d − centroid) / n on the 1-1
    Gaussians; the two sides differ at float32 rounding of the means and
    of the differences of two whole-step gradients (measured 4e-5
    relative).  No other Gaussian leaf gets any of it."""
    out, tout = anchor_grads
    (jgp_a, jnets_a, _), (jgp_0, jnets_0, _) = out[True][2], out[False][2]
    ga, g0 = tout[True][2], tout[False][2]
    want = np.asarray(jgp_a.xyz) - np.asarray(jgp_0.xyz)
    got = (ga.gp.xyz - g0.gp.xyz).numpy()
    assert np.abs(want).max() > 0
    close(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
    for n in ("f_dc", "scaling", "rotation", "opacity"):
        close(getattr(ga.gp, n) - getattr(g0.gp, n), 0.0, atol=1e-9, rtol=0, msg=n)
    net = fx.tstate.nets.deform
    n_live = 0
    for (name, _), wa, w0, pa, p0 in zip(net.named_parameters(),
                                         convert.flax_leaves(net, jnets_a.deform),
                                         convert.flax_leaves(net, jnets_0.deform),
                                         ga.nets.deform, g0.nets.deform):
        w = wa - w0
        n_live += bool(np.abs(w).max() > 0)
        close(pa - p0, w, rtol=0, atol=1e-3 * np.abs(w).max(), msg=name)
    assert n_live > 0


# --- flags and run_iteration ----------------------------------------------------

@pytest.mark.parametrize("white", [False, True])
def test_flags_for_matches_jax(white):
    """Every gate of every listed iteration, at the default schedule."""
    jcfg, tcfg = JConfig.Config(), TConfig.Config()
    jcfg.model.white_background = tcfg.model.white_background = white
    trainer = SimpleNamespace(cfg=jcfg)
    for it in (1, 499, 500, 600, 2999, 3000, 3100, 5000, 5100, 6000, 7000, 8000, 8100, 8150,
               9000, 14900, 15000, 15100, 30000):
        assert tuple(TLoop.flags_for(tcfg, it)) == tuple(JLoop.Trainer.flags_for(trainer, it)), it


def test_run_iteration_anchor_semantics(fx):
    """tests/test_train_e2e.py::test_anchor_iteration_semantics for the
    port, at iteration 8100 of the default schedule (mesh, anchor, no
    frozen positions): the new state's Gaussians, alive mask and moments
    are anchor_fn's, bit for bit (no Adam update reaches a Gaussian
    group); g_count does not advance and step does; the deform and
    appearance nets take their Adam step; the anchor loss is in the
    metrics, with the anchor step's counters."""
    jcfg, tcfg = case_cfgs(fx, "topn 2")
    it = 8100
    flags = TLoop.flags_for(tcfg, it)
    assert flags.anchor and flags.mesh and flags.skip_gaussian_update and not flags.freeze_pos
    ctx = TStep.StepContext(tcfg, fx.img, fx.img, device="cpu")
    pre = fx.tstate._replace(step=torch.tensor(it, dtype=torch.int32),
                             g_count=torch.tensor(17, dtype=torch.int32))
    F = tcfg.tpu.max_faces
    g = torch.Generator().manual_seed(0)
    draws = {"n_1": torch.rand(F, generator=g), "0_1": torch.rand(F, generator=g),
             "angle": torch.randn((tcfg.optimization.anchor_0_1_bs, 1), generator=g)}
    post, metrics = TLoop.run_iteration(ctx, pre, fx.tbatch, it, 1.0, draws={"anchor": draws})
    gp_a, gs_a, mu_a, nu_a, info = TLoop.anchor_fn(ctx, pre, fx.tbatch, draws=draws)
    for a, b in zip(list(post.gp) + list(post.g_mu) + list(post.g_nu),
                    list(gp_a) + list(mu_a) + list(nu_a)):
        assert torch.equal(a, b)
    assert torch.equal(post.gs.alive, gs_a.alive)
    assert int(post.g_count) == 17 and int(post.step) == it + 1
    for name in ("deform", "appearance"):
        changed = any(not torch.equal(a, b) for a, b in zip(
            getattr(pre.nets, name).parameters(), getattr(post.nets, name).parameters()))
        assert changed, name
    assert np.isfinite(float(metrics["anchor_loss"])) and float(metrics["anchor_loss"]) > 0
    assert int(metrics["anchor_n_merged"]) == int(info.stats["n_merged"]) > 0
    assert int(metrics["mesh_overflow"]) == 0
