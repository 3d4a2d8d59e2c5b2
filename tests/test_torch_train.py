"""The port's mesh-phase training step against the JAX package's.

One module-scoped fixture runs JAX's ``loss_and_aux`` under
``jax.value_and_grad`` and JAX's ``train_step`` once, and the port's
``loss_and_grads`` and ``train_step`` once, on the miniature fixture (grid
32, 512 Gaussian slots, 64², the ROOMY caps so the mesh is whole) with the
flags bench.py uses (mesh, use_normal, not warm, positions not frozen) and
the densify statistics on.  The warm-up flags with skip_gaussian_update
get a second train_step on each side, and real-capture data (is_blender
False) a forward with its time noise.  Adam is also compared in isolation,
fed JAX's own gradients, for two steps.  Each tolerance is stated with its
reason.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, jax_fixture, port_batch, port_fixture, t, to_numpy

from dgmesh_torch import convert
from dgmesh_torch.models.gaussians import GaussianParams
from dgmesh_torch.train import state as TState
from dgmesh_torch.train import step as TStep

from dgmesh_tpu.train import state as JState
from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)

NETS = ["deform", "deform_normal", "deform_back", "deform_back_normal", "appearance"]
JFLAGS = JStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                         anchor=False, densify_stats=True, sh_degree=1)
TFLAGS = TStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                         densify_stats=True, sh_degree=1)


@pytest.fixture(scope="module")
def tr():
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=7, **ROOMY)
    state = state._replace(step=jnp.asarray(1200, jnp.int32))   # past any LR delay
    key = jax.random.PRNGKey(0)
    M = state.gp.xyz.shape[0]

    def lg(gp, nets, so):
        return JStep.loss_and_aux(ctx, gp, nets, so, state.gs, batch, key,
                                  state.step.astype(jnp.float32), JFLAGS)

    (loss, aux), grads = jax.jit(jax.value_and_grad(lg, argnums=(0, 1, 2), has_aux=True))(
        state.gp, state.nets, jnp.zeros((M, 2)))
    new_state, metrics = jax.jit(lambda st, b: JStep.train_step(ctx, st, b, key, JFLAGS))(
        state, batch)
    tcfg, tctx, tstate, _ = port_fixture(cfg, img, state)
    tbatch = port_batch(batch)
    before = [x.clone() for x in tstate.gp] + [p.detach().clone() for n in tstate.nets
                                               for p in n.parameters()]
    tloss, taux, tgrads = TStep.loss_and_grads(tctx, tstate, tbatch, TFLAGS)
    tnew, tmetrics = TStep.train_step(tctx, tstate, tbatch, TFLAGS)
    return dict(cfg=cfg, tcfg=tcfg, ctx=ctx, tctx=tctx, state=state, tstate=tstate,
                batch=batch, tbatch=tbatch, loss=float(loss), aux=to_numpy(aux),
                g_gp=to_numpy(grads[0]), g_nets=to_numpy(grads[1]), g_screen=np.asarray(grads[2]),
                new=to_numpy(new_state), metrics=to_numpy(metrics), tloss=float(tloss),
                taux=taux, tgrads=tgrads, tnew=tnew, tmetrics=tmetrics, before=before)


def _flax_grads(tr, name):
    return convert.flax_leaves(getattr(tr["tstate"].nets, name), tr["g_nets"][name]
                               if isinstance(tr["g_nets"], dict) else getattr(tr["g_nets"], name))


# --- the whole step ---------------------------------------------------------------

def test_loss_terms_match_jax(tr):
    """Every loss term and the total: rel 1e-5 (float32 sums in other orders;
    the mask term is exact, both sides run the same hard coverage)."""
    want, got = tr["metrics"], tr["tmetrics"]
    keys = ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss",
            "img_psnr", "mesh_psnr")
    for k in keys:
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    assert abs(tr["tloss"] - tr["loss"]) <= 1e-5 * abs(tr["loss"])
    assert float(want["mask_loss"]) > 0 and float(want["laplacian_loss"]) > 0


def test_mesh_size_and_counters_match_jax_exactly(tr):
    """V, F and every capacity counter exactly; no non-finite gradient leaf."""
    want, got = tr["metrics"], tr["tmetrics"]
    for k in ("mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
              "splat_dup_overflow", "raster_overflow", "nonfinite_grad_leaves", "n_alive"):
        assert int(got[k]) == int(want[k]), k
    assert int(want["mesh_n_verts"]) > 1000 and int(want["mesh_overflow"]) == 0
    assert int(got["nonfinite_grad_leaves"]) == 0


@pytest.mark.parametrize("name", GaussianParams._fields)
def test_gaussian_grads_match_jax(tr, name):
    """Each Gaussian gradient leaf: rel 2e-3 of its largest value + abs 1e-9.
    The mesh path carries the DPSR's ~1e-7 relative difference in φ into the
    vertices, and the vertex colour net's ReLUs (see the net test below)
    into d verts; measured ~4e-5 relative."""
    want = np.asarray(getattr(tr["g_gp"], name))
    got = getattr(tr["tgrads"].gp, name).numpy()
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max() + 1e-9,
                               err_msg=name)


def test_screen_offset_grad_matches_jax(tr):
    """The view-space gradient (the densify statistic's input): rel 1e-4."""
    want, got = tr["g_screen"], tr["tgrads"].screen.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", NETS)
def test_net_grads_match_jax(tr, name):
    """Each gradient leaf of the net: rel 5e-2 of its largest value + abs
    1e-9.  Why so loose: a ReLU whose pre-activation lies within float32
    rounding of 0 (~1 of the ~1e7 (row, unit) pairs of this fixture) takes
    the other side in the other framework; the gradient of every layer
    below it then differs by that row's term (up to ~3% of a leaf here).
    Measured in isolation against float64 on another input, the same kind
    of flip put torch's float32 gradient 0.5% off and JAX's 5e-7 off; it is
    a property of float32, not a fault of either.  The leaves above the
    flipped unit agree to ~1e-6."""
    want = _flax_grads(tr, name)
    got = [g.numpy() for g in getattr(tr["tgrads"].nets, name)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-2 * np.abs(w).max() + 1e-9,
                                   err_msg=f"leaf {i}")
    assert max(np.abs(w).max() for w in want) > 0


def test_densify_statistics_match_jax(tr):
    """max_radii2d and denom exactly; xyz_grad_accum (‖d screen‖) rel 1e-4."""
    want, got = tr["new"].gs, tr["tnew"].gs
    np.testing.assert_array_equal(got.max_radii2d.numpy(), want.max_radii2d)
    np.testing.assert_array_equal(got.denom.numpy(), want.denom)
    w = np.asarray(want.xyz_grad_accum)
    np.testing.assert_allclose(got.xyz_grad_accum.numpy(), w, rtol=0, atol=1e-4 * w.max())
    assert w.max() > 0 and want.denom.sum() > 100


def test_updated_parameters_match_jax(tr):
    """After the step, where JAX's gradient is well above the gradient
    tolerance (so both Adam steps move the same way), every Gaussian leaf
    and every net parameter abs 1e-6; elsewhere Adam's first step moves an
    element by ~±lr whatever its size, so only ‖Δ‖ ≤ 2·lr is held.  Counts
    and the step exactly."""
    new, tnew = tr["new"], tr["tnew"]
    assert int(tnew.step) == int(new.step) and int(tnew.g_count) == int(new.g_count)
    for name in GaussianParams._fields:
        w = np.asarray(getattr(new.gp, name))
        g = getattr(tnew.gp, name).numpy()
        gj = np.asarray(getattr(tr["g_gp"], name))
        sure = np.abs(gj) > 1e-2 * np.abs(gj).max()
        np.testing.assert_allclose(g[sure], w[sure], rtol=0, atol=1e-6, err_msg=name)
        lr = float(getattr(TState.gaussian_group_lrs(tr["tstate"].step, tr["tcfg"]), name))
        assert np.abs(g - w).max() <= 2.0 * lr * 1.001 + 1e-7, name
    for name in NETS:
        want = convert.flax_leaves(getattr(tr["tstate"].nets, name), getattr(new.nets, name))
        grads = _flax_grads(tr, name)
        for p, w, gj in zip(getattr(tnew.nets, name).parameters(), want, grads):
            sure = np.abs(gj) > 0.1 * np.abs(gj).max()
            np.testing.assert_allclose(p.detach().numpy()[sure], w[sure], rtol=0, atol=1e-6,
                                       err_msg=name)


def test_train_step_leaves_its_input_state_unchanged(tr):
    """The port's step is functional, as JAX's: a second step from the same
    input state is possible (chip_smoke times five of them)."""
    after = [x for x in tr["tstate"].gp] + [p.detach() for n in tr["tstate"].nets
                                            for p in n.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(tr["before"], after))
    assert int(tr["tstate"].step) == 1200 and int(tr["tstate"].g_count) == 0


def test_inactive_nets_keep_parameters_and_moments(tr):
    """With use_normal off, the two normal nets get no Adam step: the new
    state holds the same modules and the same moments."""
    flags = TFLAGS._replace(use_normal=False, densify_stats=False)
    new, _ = TStep.train_step(tr["tctx"], tr["tstate"], tr["tbatch"], flags)
    for name in ("deform_normal", "deform_back_normal"):
        assert getattr(new.nets, name) is getattr(tr["tstate"].nets, name)
        assert getattr(new.net_opt, name) is getattr(tr["tstate"].net_opt, name)
    assert int(new.net_opt.deform.count) == 1


# --- the warm-up flags, with no Gaussian update ---------------------------------------

JWARM = JFLAGS._replace(warm=True, freeze_pos=True, use_normal=False, skip_gaussian_update=True)
TWARM = TFLAGS._replace(warm=True, freeze_pos=True, use_normal=False, skip_gaussian_update=True)


@pytest.fixture(scope="module")
def warm(tr):
    """JAX's and the port's train_step from the fixture state with the
    warm-up flags (no deformation, no cycle loss, the deform nets idle,
    positions frozen in the mesh) and skip_gaussian_update, as on a
    densify iteration."""
    key = jax.random.PRNGKey(0)
    new, metrics = jax.jit(lambda st, b: JStep.train_step(tr["ctx"], st, b, key, JWARM))(
        tr["state"], tr["batch"])
    tnew, tmetrics = TStep.train_step(tr["tctx"], tr["tstate"], tr["tbatch"], TWARM)
    return dict(new=to_numpy(new), metrics=to_numpy(metrics), tnew=tnew, tmetrics=tmetrics)


def test_warm_step_losses_and_counters_match_jax(warm):
    """No cycle loss on either side; the other loss terms rel 1e-5 (as the
    main step's); V, F and every counter exactly."""
    want, got = warm["metrics"], warm["tmetrics"]
    assert "cycle_loss" not in want and "cycle_loss" not in got
    for k in ("loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss", "img_psnr",
              "mesh_psnr"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    for k in ("mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
              "splat_dup_overflow", "raster_overflow", "nonfinite_grad_leaves", "n_alive"):
        assert int(got[k]) == int(want[k]), k
    assert int(want["mesh_n_verts"]) > 1000


def test_skipped_gaussian_update_keeps_gaussians_and_moments(tr, warm):
    """skip_gaussian_update: on both sides the Gaussian leaves, their
    moments and the count stay the input state's, bit for bit, while the
    densify statistics still advance and match JAX's (max_radii2d and denom
    exactly, xyz_grad_accum rel 1e-4)."""
    st, tst, new, tnew = tr["state"], tr["tstate"], warm["new"], warm["tnew"]
    for f in GaussianParams._fields:
        for tree in ("gp", "g_mu", "g_nu"):
            np.testing.assert_array_equal(getattr(getattr(new, tree), f),
                                          np.asarray(getattr(getattr(st, tree), f)))
            assert torch.equal(getattr(getattr(tnew, tree), f), getattr(getattr(tst, tree), f))
    assert int(new.g_count) == int(tnew.g_count) == 0
    np.testing.assert_array_equal(tnew.gs.max_radii2d.numpy(), new.gs.max_radii2d)
    np.testing.assert_array_equal(tnew.gs.denom.numpy(), new.gs.denom)
    w = np.asarray(new.gs.xyz_grad_accum)
    np.testing.assert_allclose(tnew.gs.xyz_grad_accum.numpy(), w, rtol=0, atol=1e-4 * w.max())
    assert w.max() > 0


def test_warm_step_updates_only_the_appearance_net(tr, warm):
    """The deform nets are idle in the warm-up and use_normal is off: on
    both sides they keep their parameters and moments.  The appearance net
    (mesh on) takes its Adam step: its first moments (0.1·g) match JAX's
    within 5e-2 of each leaf's max (the ReLU kinks of the net gradient test
    above); its parameters abs 1e-6 where JAX's |mu| is above a tenth of
    the leaf's max, and within 2·lr elsewhere (Adam's first step)."""
    st, tst, new, tnew = tr["state"], tr["tstate"], warm["new"], warm["tnew"]
    for name in NETS[:4]:
        assert getattr(tnew.nets, name) is getattr(tst.nets, name)
        assert getattr(tnew.net_opt, name) is getattr(tst.net_opt, name)
        ref = getattr(tst.nets, name)
        assert int(getattr(new.net_opt, name).count) == 0
        for w, p in zip(convert.flax_leaves(ref, getattr(new.nets, name)), ref.parameters()):
            np.testing.assert_array_equal(w, p.detach().numpy())
    opt, jopt = tnew.net_opt.appearance, new.net_opt.appearance
    assert int(opt.count) == int(jopt.count) == 1
    ref = tst.nets.appearance
    lr = float(TState.net_lrs(tst.step, tr["tcfg"]).appearance)
    jmu = convert.flax_leaves(ref, jopt.mu)
    for m, w in zip(opt.mu, jmu):
        np.testing.assert_allclose(m.numpy(), w, rtol=0, atol=5e-2 * np.abs(w).max() + 1e-12)
    for p, w, m in zip(tnew.nets.appearance.parameters(),
                       convert.flax_leaves(ref, new.nets.appearance), jmu):
        p = p.detach().numpy()
        sure = np.abs(m) > 0.1 * np.abs(m).max()
        assert sure.any()
        np.testing.assert_allclose(p[sure], w[sure], rtol=0, atol=1e-6)
        assert np.abs(p - w).max() <= 2.0 * lr * 1.001 + 1e-7


# --- real-capture data: the time noise ------------------------------------------------

JNOISE = JStep.StepFlags(warm=False, mesh=False, freeze_pos=False, use_normal=True,
                         anchor=False, densify_stats=False, sh_degree=1)
TNOISE = TStep.StepFlags(warm=False, mesh=False, use_normal=True, densify_stats=False,
                         sh_degree=1)


@pytest.fixture(scope="module")
def noisy():
    """A real-capture state (is_blender False: nets with no timenet, time
    noise on) at step 1200 with a time interval of 1 (noise magnitude
    ~1.5e-2 per draw), the mesh off: JAX's loss_and_aux with its key, and
    the port's loss_and_aux for given standard-normal draws."""
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=5, is_blender=False)
    state = state._replace(step=jnp.asarray(1200, jnp.int32))
    batch = batch._replace(time_interval=jnp.asarray(1.0, jnp.float32))
    key = jax.random.PRNGKey(3)
    M = state.gp.xyz.shape[0]
    _, aux = jax.jit(lambda gp, nets: JStep.loss_and_aux(
        ctx, gp, nets, jnp.zeros((M, 2)), state.gs, batch, key,
        state.step.astype(jnp.float32), JNOISE))(state.gp, state.nets)
    draws = [float(jax.random.normal(k, ())) for k in jax.random.split(key)]
    _, tctx, tstate, _ = port_fixture(cfg, img, state)
    tbatch = port_batch(batch)

    def port(draws=None, gen=None, st=tstate):
        patch = (mock.patch.object(TStep, "_normal_draws", lambda g: torch.tensor(draws))
                 if draws is not None else contextlib.nullcontext())
        with torch.no_grad(), patch:
            _, taux = TStep.loss_and_aux(tctx, st.gp, st.nets, torch.zeros((M, 2)),
                                         st.gs, tbatch, st.step.float(), TNOISE, gen)
        return {k: float(v) for k, v in taux["losses"].items()}

    return dict(want={k: float(v) for k, v in aux["losses"].items()}, draws=draws, port=port,
                state=state, tcfg=tctx.cfg, tstate=tstate)


def test_time_noise_matches_jax(noisy):
    """Fed JAX's two draws, the port's cycle and image losses match JAX's
    rel 1e-5.  With both draws 0 the cycle loss moves by far more than
    that, so the noise is on, and each draw lands where JAX puts it (the
    deformation's first, the cycle's second; swapped, they would not
    match)."""
    want = noisy["want"]
    assert set(want) == {"cycle_loss", "img_loss"}
    got = noisy["port"](noisy["draws"])
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-5 * abs(w), k
    flat = noisy["port"]([0.0, 0.0])
    assert abs(flat["cycle_loss"] - want["cycle_loss"]) > 1e-3 * want["cycle_loss"]
    swapped = noisy["port"](noisy["draws"][::-1])
    assert abs(swapped["cycle_loss"] - want["cycle_loss"]) > 1e-3 * want["cycle_loss"]


def test_resume_from_a_non_blender_jax_msgpack(noisy, tmp_path):
    """The real-capture state (no timenet, so flax numbers each deform net's
    heads from Dense_0) written by JAX's save_checkpoint as flax's
    state_N.msgpack and read by the port's load_checkpoint: every leaf, net
    parameter, Adam moment and count exactly as convert.state_from_jax gives
    them from JAX's arrays, and the heads where JAX has them; the loss
    terms from the loaded state, fed JAX's draws, match JAX's rel 1e-5."""
    from dgmesh_torch.train import checkpoint as TCk
    from dgmesh_tpu.train import checkpoint as JCk
    JCk.save_checkpoint(noisy["state"], str(tmp_path), 1200)
    st = TCk.load_checkpoint(noisy["tcfg"], str(tmp_path), device="cpu")
    want = noisy["tstate"]
    for tree in ("gp", "gs", "g_mu", "g_nu"):
        for a, b in zip(getattr(st, tree), getattr(want, tree)):
            assert torch.equal(a, b), tree
    for name in TState.NetParams._fields:
        net = getattr(st.nets, name)
        assert not net.is_blender and not hasattr(net, "timenet0")
        for a, b in zip(net.parameters(), getattr(want.nets, name).parameters()):
            assert torch.equal(a, b), name
        oa, ob = getattr(st.net_opt, name), getattr(want.net_opt, name)
        assert int(oa.count) == int(ob.count)
        assert all(torch.equal(a, b) for a, b in zip(oa.mu + oa.nu, ob.mu + ob.nu))
    head = to_numpy(noisy["state"].nets.deform)["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(st.nets.deform.head_xyz.weight.detach().numpy(), head.T)
    assert int(st.step) == 1200
    got = noisy["port"](noisy["draws"], st=st)
    for k, w in noisy["want"].items():
        assert abs(got[k] - w) <= 1e-5 * abs(w), k


def test_time_noise_follows_the_generator(noisy):
    """The port draws the time noise from the generator it is given: the
    same seed gives the same losses, another seed other ones."""
    a, b, c = (noisy["port"](gen=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert a == b and a["cycle_loss"] != c["cycle_loss"]


# --- Adam in isolation, fed JAX's own gradients ---------------------------------------

def test_gaussian_adam_matches_jax_for_two_steps(tr):
    """Masked Gaussian Adam, two steps with JAX's gradients (the second
    scaled by −0.7 plus noise), density_thres driven into its ±1 clamp:
    parameters and moments abs 1e-6 (the same float32 arithmetic), counts
    exactly; dead slots keep zero moments and their parameters."""
    st = tr["state"]
    rng = np.random.default_rng(9)
    g1 = tr["g_gp"]
    g2 = type(g1)(*[np.asarray(-0.7 * np.asarray(x) + rng.normal(0, 1e-4, np.shape(x)),
                               np.float32) for x in g1])
    jlrs = JState.gaussian_group_lrs(st.step.astype(jnp.float32), tr["cfg"])
    jlrs = jlrs._replace(density_thres=jnp.asarray(1.5))
    tlrs = TState.gaussian_group_lrs(tr["tstate"].step, tr["tcfg"])
    for f in GaussianParams._fields:
        if f != "density_thres":
            assert abs(float(getattr(tlrs, f)) - float(getattr(jlrs, f))) \
                <= 1e-6 * float(getattr(jlrs, f)), f
    tlrs = tlrs._replace(density_thres=torch.tensor(1.5))
    alive = st.gs.alive
    jp, jm, jv, jc = st.gp, st.g_mu, st.g_nu, st.g_count
    tp, tm, tv, tc = (tr["tstate"].gp, tr["tstate"].g_mu, tr["tstate"].g_nu,
                      tr["tstate"].g_count)
    for g in (g1, g2):
        jp, jm, jv, jc = JState.gaussian_adam_update(
            jp, jax.tree.map(jnp.asarray, g), jm, jv, jc, jlrs, alive)
        tp, tm, tv, tc = TState.gaussian_adam_update(
            tp, GaussianParams(*[t(x) for x in g]), tm, tv, tc, tlrs, tr["tstate"].gs.alive)
    assert int(tc) == int(jc) == 2
    dead = ~np.asarray(alive)
    for f in GaussianParams._fields:
        for got, want in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
        if f != "density_thres":
            assert not getattr(tm, f).numpy()[dead].any()
            np.testing.assert_array_equal(getattr(tp, f).numpy()[dead],
                                          np.asarray(getattr(st.gp, f))[dead])
    assert abs(float(tp.density_thres)) == 1.0


@pytest.mark.parametrize("name", NETS)
def test_net_adam_matches_optax_for_two_steps(tr, name):
    """Per-net Adam (optax scale_by_adam, eps 1e-15, then −lr·u), two steps
    with JAX's gradients (the second scaled by −0.7): parameters, mu and nu
    abs 1e-6 + rel 1e-6 of each leaf's scale; counts exactly."""
    st, tst = tr["state"], tr["tstate"]
    lr = float(getattr(JState.net_lrs(st.step.astype(jnp.float32), tr["cfg"]), name))
    tlr = getattr(TState.net_lrs(tst.step, tr["tcfg"]), name)
    assert abs(float(tlr) - lr) <= 1e-6 * lr
    gj = getattr(tr["g_nets"], name)
    jp, jo = getattr(st.nets, name), getattr(st.net_opt, name)
    tnet, topt = getattr(tst.nets, name), getattr(tst.net_opt, name)
    for s in (1.0, -0.7):
        gs = jax.tree.map(lambda x: jnp.asarray(x) * s, gj)
        jp, jo = JState.net_adam_update(jp, gs, jo, lr)
        tnet, topt = TState.net_adam_update(
            tnet, [t(x) * s for x in convert.flax_leaves(tnet, gj)], topt, tlr)
    assert int(topt.count) == int(jo.count) == 2
    ref = getattr(tst.nets, name)
    for got, want in ((list(tnet.parameters()), convert.flax_leaves(ref, jp)),
                      (topt.mu, convert.flax_leaves(ref, jo.mu)),
                      (topt.nu, convert.flax_leaves(ref, jo.nu))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), w, rtol=0,
                                       atol=1e-6 + 1e-6 * np.abs(w).max())


def test_convert_carries_the_optimizer_state(tr):
    """JAX's state after its step (non-zero moments, counts 1, step 1201)
    carried across by convert.state_from_jax: every moment leaf exact."""
    new = tr["new"]
    got = convert.state_from_jax(tr["tcfg"], new, device="cpu")
    assert int(got.step) == int(new.step) == 1201 and int(got.g_count) == int(new.g_count) == 1
    for f in GaussianParams._fields:
        np.testing.assert_array_equal(getattr(got.g_mu, f).numpy(), np.asarray(getattr(new.g_mu, f)))
        np.testing.assert_array_equal(getattr(got.g_nu, f).numpy(), np.asarray(getattr(new.g_nu, f)))
    for name in NETS:
        net, opt, jopt = getattr(got.nets, name), getattr(got.net_opt, name), \
            getattr(new.net_opt, name)
        assert int(opt.count) == int(jopt.count) == 1
        for g, w in zip(opt.mu, convert.flax_leaves(net, jopt.mu)):
            np.testing.assert_array_equal(g.numpy(), w)
        for g, w in zip(opt.nu, convert.flax_leaves(net, jopt.nu)):
            np.testing.assert_array_equal(g.numpy(), w)
        assert any(x.any() for x in opt.mu)
