"""The port's sharded training step (``StepContext(device_mesh=...)``) at n = 2
and n = 4 gloo ranks on the CPU: against JAX's single-device train_step (the
loss at JAX's own bound for its sharded step, rtol 2e-5,
tests/test_graft_entry.py::test_sharded_step_matches_single_device, and the
mesh size), and against the port's single-device step (every metric,
gradient and the updated state); and the port's dry run.

The state is JAX's miniature one at that test's shapes (grid 16, 512 slots,
32², caps 2048/4096 vertices/faces; duplicate lists of 65,536), the
zero-initialised heads given seeded noise, carried into the port by
convert.py.  Two configurations run in each
spawn: the default (spectral DPSR: the sharded step gathers the points and
solves whole) and ``dpsr_div_splat`` (the sharded DPSR).  The sharded marching
tets, splat and mesh raster run in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ge, perturb_flax_heads, port_batch, port_fixture, to_numpy
import torch_parallel_ranks as R

from dgmesh_torch.graft_entry import dryrun_multichip
from dgmesh_torch.models.gaussians import GaussianParams
from dgmesh_torch.parallel import sharding as SH
from dgmesh_torch.train import state as TState
from dgmesh_torch.train import step as TStep

from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)
NS = (2, 4)
CASES = ("spectral", "splat")
JFLAGS = JStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                         anchor=False, sh_degree=1)
TFLAGS = TStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True, sh_degree=1)


def _jax_case(div_splat):
    cfg, img = ge._tiny_cfg(grid_res=16, max_g=512, img=32)
    cfg.tpu.max_verts = 2048
    cfg.tpu.max_faces = 4096
    # duplicate lists that hold every (item, tile) pair: where one overflows,
    # each rank keeps its own 2·max_dup/n and the sharded step drops less
    cfg.tpu.max_dup = cfg.tpu.max_face_dup = 1 << 16
    cfg.tpu.use_pallas = True
    cfg.tpu.dpsr_div_splat = div_splat
    ctx, state, batch = ge._make_state_and_batch(cfg, img)
    nets = perturb_flax_heads(state.nets, np.random.default_rng(3), 1e-3)
    return cfg, img, ctx, state._replace(nets=jax.tree.map(jnp.asarray, nets)), batch


@pytest.fixture(scope="module")
def case():
    out = {}
    for name in CASES:
        cfg, img, ctx, state, batch = _jax_case(name == "splat")
        entry = {}
        if name == "spectral":
            _, m = jax.jit(lambda st, b: JStep.train_step(ctx, st, b, jax.random.PRNGKey(0),
                                                          JFLAGS))(state, batch)
            entry["jax"] = to_numpy(m)
        tcfg, tctx, tstate, _ = port_fixture(cfg, img, state)
        tbatch = port_batch(batch)
        loss, _, grads = TStep.loss_and_grads(tctx, tstate, tbatch, TFLAGS)
        grads, bad = TStep.sanitize(grads)
        new, metrics = TStep.train_step(tctx, tstate, tbatch, TFLAGS)
        entry.update(cfg=tcfg, img=img, state=tstate, batch=tbatch, loss=loss, grads=grads,
                     new=new, metrics=metrics)
        out[name] = entry
    return out


@pytest.fixture(scope="module")
def runs(case):
    return {n: {name: SH.spawn(R.step_rank, n, "gloo", "cpu",
                               args=(c["cfg"], c["img"], c["state"], c["batch"], TFLAGS),
                               threads=1)
                for name, c in case.items()}
            for n in NS}


@pytest.mark.parametrize("n", NS)
def test_sharded_step_matches_jax(case, runs, n):
    """Loss within rtol 2e-5 of JAX's single-device step, the mesh size equal."""
    want = case["spectral"]["jax"]
    for rank in runs[n]["spectral"]:
        got = rank["metrics"]
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=2e-5, atol=1e-6)
        assert int(got["mesh_n_verts"]) == int(want["mesh_n_verts"]) > 100
        assert int(got["mesh_n_faces"]) == int(want["mesh_n_faces"])


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n", NS)
def test_sharded_step_metrics(case, runs, n, name):
    """Every loss term within 1e-5 relative of the single-device step's (the
    mask term exactly: hard coverage); the mesh size, every capacity counter,
    the live count and the non-finite leaf count equal; every rank the same."""
    want = case[name]["metrics"]
    for rank in runs[n][name]:
        got = rank["metrics"]
        assert set(got) == set(want)
        for k in ("loss", "cycle_loss", "mesh_img_loss", "laplacian_loss", "img_loss",
                  "img_psnr", "mesh_psnr", "psr_min", "psr_max", "normal_norm"):
            assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])) + 1e-7, k
        assert float(got["mask_loss"]) == float(want["mask_loss"]) > 0
        for k in ("mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
                  "splat_dup_overflow", "raster_overflow", "n_alive", "nonfinite_grad_leaves"):
            assert int(got[k]) == int(want[k]), k


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("n", NS)
def test_sharded_step_gradients(case, runs, n, name):
    """Each Gaussian leaf's gradient within 1e-4 of its largest value (the
    rows' gradients sum in other orders; the DPSR's transforms run in another
    order); each net leaf ‖Δ‖/‖g‖ ≤ 1e-4; the view-space gradient within
    1e-4 — so no leaf carries an n-fold gradient."""
    want = case[name]["grads"]
    got = runs[n][name][0]
    for f, g, w in zip(GaussianParams._fields, got["g_gp"], want.gp):
        scale = float(w.abs().max())
        if scale == 0:
            assert float(g.abs().max()) <= 1e-12, f
            continue
        assert float((g - w).abs().max()) <= 1e-4 * scale, f
    for gn, wn in zip(got["g_nets"], want.nets):
        for g, w in zip(gn, wn):
            if float(w.norm()) > 0:
                assert float((g - w).norm()) <= 1e-4 * float(w.norm())
            else:
                assert float(g.norm()) == 0.0
    scale = float(want.screen.abs().max())
    assert scale > 0 and float((got["g_screen"] - want.screen).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("n", NS)
def test_sharded_step_new_state(case, runs, n):
    """The gathered new state against the single-device one: each Gaussian
    group within 2·lr (Adam's first step moves an element by ~±lr whatever
    its gradient's size, so a gradient near 0 may flip), the statistics
    and counts exactly, the net parameters within 2·lr."""
    c = case["spectral"]
    want, got = c["new"], runs[n]["spectral"][0]["new"]
    lrs = TState.gaussian_group_lrs(c["state"].step, c["cfg"])
    for f in GaussianParams._fields:
        lr = float(getattr(lrs, f))
        d = (getattr(got.gp, f) - getattr(want.gp, f)).abs().max()
        assert float(d) <= 2.0 * lr * 1.001 + 1e-7, f
    for a, b in zip(got.gs, want.gs):
        assert torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-9)
    assert int(got.g_count) == int(want.g_count) and int(got.step) == int(want.step)
    nlrs = TState.net_lrs(c["state"].step.float(), c["cfg"])
    for name, gn, wn in zip(TState.NetParams._fields, got.nets, want.nets):
        lr = float(getattr(nlrs, name))
        for p, q in zip(gn.parameters(), wn.parameters()):
            assert float((p - q).detach().abs().max()) <= 2.0 * lr * 1.001 + 1e-7, name


def test_dryrun_multichip_cpu():
    """The port's dry run: two gloo ranks on the CPU, one sharded step at
    the dry run's shapes (grid 64, 16,384 slots), a finite loss, a mesh."""
    m = dryrun_multichip(2, device="cpu")
    assert np.isfinite(m["loss"]) and m["mesh_n_verts"] > 1000
