"""The port's mesh-phase training step against JAX's, in the fused bf16
configuration (``mlp_bf16 = mlp_fused = True`` on both sides).

One module-scoped fixture runs JAX's ``loss_and_aux`` under
``jax.value_and_grad`` and JAX's ``train_step`` once (six fused trunks per
step, the Pallas kernels in interpret mode), and the port's
``loss_and_grads`` and ``train_step`` once (the kernels' plain twins), on
the miniature fixture of tests/test_torch_train.py (grid 32, 512 Gaussian
slots, 64², the ROOMY caps) with bench.py's flags and the densify
statistics on.  Each tolerance is stated with its reason; where it is
looser than the float32 step's (tests/test_torch_train.py), the reason is
the bf16 rounding flips described in tests/test_torch_mlp_fused.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, jax_fixture, port_batch, port_fixture, to_numpy

from dgmesh_torch import convert
from dgmesh_torch.models.gaussians import GaussianParams
from dgmesh_torch.ops import mlp_fused as MF
from dgmesh_torch.train import step as TStep

from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)

NETS = ["deform", "deform_normal", "deform_back", "deform_back_normal", "appearance"]
JFLAGS = JStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                         anchor=False, densify_stats=True, sh_degree=1)
TFLAGS = TStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                         densify_stats=True, sh_degree=1)


@pytest.fixture(scope="module")
def fz():
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=7, mlp_bf16=True,
                                              mlp_fused=True, **ROOMY)
    state = state._replace(step=jnp.asarray(1200, jnp.int32))
    key = jax.random.PRNGKey(0)
    M = state.gp.xyz.shape[0]
    assert ctx.nets_def.deform.fuse and ctx.nets_def.appearance.fuse

    def lg(gp, nets, so):
        return JStep.loss_and_aux(ctx, gp, nets, so, state.gs, batch, key,
                                  state.step.astype(jnp.float32), JFLAGS)

    (loss, aux), grads = jax.jit(jax.value_and_grad(lg, argnums=(0, 1, 2), has_aux=True))(
        state.gp, state.nets, jnp.zeros((M, 2)))
    new_state, metrics = jax.jit(lambda st, b: JStep.train_step(ctx, st, b, key, JFLAGS))(
        state, batch)
    tcfg, tctx, tstate, _ = port_fixture(cfg, img, state)
    tbatch = port_batch(batch)
    calls = []
    real = MF.trunk_fwd_ref

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    MF.trunk_fwd_ref = counted
    try:
        tloss, taux, tgrads = TStep.loss_and_grads(tctx, tstate, tbatch, TFLAGS)
    finally:
        MF.trunk_fwd_ref = real
    tnew, tmetrics = TStep.train_step(tctx, tstate, tbatch, TFLAGS)
    return dict(tcfg=tcfg, tctx=tctx, tstate=tstate, tbatch=tbatch, loss=float(loss),
                g_gp=to_numpy(grads[0]),
                g_nets=to_numpy(grads[1]), g_screen=np.asarray(grads[2]),
                new=to_numpy(new_state), metrics=to_numpy(metrics), tloss=float(tloss),
                tgrads=tgrads, tnew=tnew, tmetrics=tmetrics, calls=calls)


def test_the_step_runs_six_fused_trunks(fz):
    """The port's step is in fused mode and sends six trunks through the
    fused forward (deform, deform_normal, the two cycle nets, deform_back
    and appearance on the mesh vertices), each of 93 input lanes."""
    assert fz["tctx"].mlp_mode == "fused"
    assert len(fz["calls"]) == 6 and all(s[1] == 93 for s in fz["calls"])
    assert sorted(s[0] for s in fz["calls"])[:4] == [512] * 4


def test_fused_loss_terms_match_jax(fz):
    """Every loss term and the total: rel 1e-4 (the float32 step holds
    1e-5; here the nets' outputs also carry bf16 rounding flips, which
    reach the losses through the deformations and vertex colours)."""
    want, got = fz["metrics"], fz["tmetrics"]
    for k in ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss",
              "img_psnr", "mesh_psnr"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-4 * abs(float(want[k])), k
    assert abs(fz["tloss"] - fz["loss"]) <= 1e-4 * abs(fz["loss"])
    assert float(want["cycle_loss"]) > 0 and float(want["mask_loss"]) > 0


def test_fused_mesh_size_and_counters_match_jax_exactly(fz):
    """V, F and every capacity counter exactly; no non-finite gradient leaf."""
    want, got = fz["metrics"], fz["tmetrics"]
    for k in ("mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
              "splat_dup_overflow", "raster_overflow", "nonfinite_grad_leaves", "n_alive"):
        assert int(got[k]) == int(want[k]), k
    assert int(want["mesh_n_verts"]) > 1000 and int(want["mesh_overflow"]) == 0


@pytest.mark.parametrize("name", GaussianParams._fields)
def test_fused_gaussian_grads_match_jax(fz, name):
    """Each Gaussian gradient leaf: rel 2e-3 of its largest value + abs
    1e-9, as in the float32 step (the leaves reach the nets only through
    their inputs and the vertex colours, where a bf16 flip is one term)."""
    want = np.asarray(getattr(fz["g_gp"], name))
    got = getattr(fz["tgrads"].gp, name).numpy()
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max() + 1e-9,
                               err_msg=name)


def test_fused_screen_offset_grad_matches_jax(fz):
    """The view-space gradient (the densify statistic's input): rel 1e-4."""
    want, got = fz["g_screen"], fz["tgrads"].screen.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", NETS)
def test_fused_net_grads_match_jax(fz, name):
    """Each gradient leaf of the net, through pack_trunk and the twin of
    kernel 6, against JAX's: the output heads to 1e-2 of the leaf's largest
    value (they see the trunk's output, where a bf16 flip is one ulp of one
    element; measured ≤ 3.3e-3), the trunk and timenet leaves to 1.5e-1,
    and so deform_back's heads, whose gradient arrives through the
    appearance trunk (``appearance(v + d_back)``; measured 1.9e-2).
    Why so loose: a ReLU mask that flips takes one row's term of a unit out
    of a leaf (tests/test_torch_train.py), and bf16 rounding flips move
    pre-activations far more than float32 rounding does.  The vertex
    colour gradient sits on few vertices, so the appearance and deform_back
    trunks are the most sensitive.  The port against itself with float64
    sums in the twins stays inside the same limits
    (test_fused_grads_within_the_summation_order_spread)."""
    net = getattr(fz["tstate"].nets, name)
    want = convert.flax_leaves(net, getattr(fz["g_nets"], name))
    got = [g.numpy() for g in getattr(fz["tgrads"].nets, name)]
    heads = [k.startswith("head_") for k, _ in net.named_parameters()]
    assert len(got) == len(want) == len(heads)
    for i, (g, w, head) in enumerate(zip(got, want, heads)):
        tol = 1e-2 if head and name != "deform_back" else 1.5e-1
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max() + 1e-9,
                                   err_msg=f"leaf {i}")
    assert max(np.abs(w).max() for w in want) > 0


def test_fused_grads_within_the_summation_order_spread(fz, monkeypatch):
    """The port against itself with float64 sums in the twins of kernels 5
    and 6 (the same exact bf16 products): every gradient leaf stays inside
    the limits that the tests above hold against JAX (Gaussian leaves
    2e-3, the heads 1e-2 but deform_back's, the other net leaves 1.5e-1),
    and some net leaf moves by more than 1e-3 of its max: those limits are
    of the size of what summation order alone does, not looser."""
    monkeypatch.setattr(MF, "_layer", lambda h, w: (h.double() @ w.double()).float())
    _, _, g64 = TStep.loss_and_grads(fz["tctx"], fz["tstate"], fz["tbatch"], TFLAGS)
    g32 = fz["tgrads"]

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    for name in GaussianParams._fields:
        assert rel(getattr(g64.gp, name), getattr(g32.gp, name)) <= 2e-3, name
    moved = 0.0
    for name in NETS:
        net = getattr(fz["tstate"].nets, name)
        for (k, _), a, b in zip(net.named_parameters(), getattr(g64.nets, name),
                                getattr(g32.nets, name)):
            tol = 1e-2 if k.startswith("head_") and name != "deform_back" else 1.5e-1
            assert rel(a, b) <= tol, (name, k, rel(a, b))
            moved = max(moved, rel(a, b))
    assert moved > 1e-3, moved


def test_fused_densify_statistics_match_jax(fz):
    """max_radii2d and denom exactly; xyz_grad_accum (‖d screen‖) rel 1e-4."""
    want, got = fz["new"].gs, fz["tnew"].gs
    np.testing.assert_array_equal(got.max_radii2d.numpy(), want.max_radii2d)
    np.testing.assert_array_equal(got.denom.numpy(), want.denom)
    w = np.asarray(want.xyz_grad_accum)
    np.testing.assert_allclose(got.xyz_grad_accum.numpy(), w, rtol=0, atol=1e-4 * w.max())
