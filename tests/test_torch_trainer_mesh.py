"""The port's Trainer against JAX's on the iteration that opens the mesh
phase: the one-shot normal init at dpsr_iter, the mesh-phase step, and a
densify/prune on the same iteration, with JAX's random draws injected.

The dataset and config are test_torch_trainer.py's (64², grid 32, 512
Gaussian slots, Pallas on in interpret mode, occ_res 16), with the
schedule moved so that iteration 2 is the first mesh iteration and a
densify iteration (skip_gaussian_update), not warm, positions frozen in
the mesh, the normal nets on.  Both trainers start from JAX's initial
state; JAX runs iteration 2 directly (one step program).  JAX derives the
iteration's keys from fold_in(PRNGKey(seed), 2); the normal init's
surface sampler and the split's normal draws both come from its third key
(split in two), and are replayed into the port's run_iteration.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_parity_fixture import to_numpy
from test_torch_trainer import NETS, SEED, dataset, trainer_configs

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch import convert  # noqa: E402
from dgmesh_torch.models.gaussians import GaussianParams  # noqa: E402
from dgmesh_torch.train import loop as TLoop  # noqa: E402
from dgmesh_torch.data import scene as TScene  # noqa: E402
from dgmesh_tpu.data import scene as JScene  # noqa: E402
from dgmesh_tpu.train import loop as JLoop  # noqa: E402

torch.set_num_threads(1)

IT = 2
SCHEDULE = dict(warm_up=1, dpsr_iter=IT, normal_warm_up=1, normal_net_warmup=0,
                densify_from_iter=1, densify_until_iter=4, densification_interval=2,
                anchor_iter=100, opacity_reset_interval=100_000, densify_grad_threshold=1e-5)


def t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    data = dataset(tmp_path_factory)
    jc, tc = trainer_configs(data, **SCHEDULE)
    jt = JLoop.Trainer(jc, JScene.Scene(jc, shuffle=True, seed=SEED), seed=SEED)
    before = to_numpy(jt.state)
    flags = jt.flags_for(IT)
    assert flags.mesh and flags.skip_gaussian_update and flags.freeze_pos and not flags.warm
    jm = {k: float(v) for k, v in jt.run_iteration(IT).items()}
    after = to_numpy(jt.state)
    # the iteration's draws, as JAX's run_iteration and its callees derive them
    _, _, k3 = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), IT), 3)
    ka, kb = jax.random.split(k3)
    M = jc.tpu.max_gaussians
    draws = {"normal_init": {"u": t(jax.random.uniform(ka, (M,))),
                             "uv": t(jax.random.uniform(kb, (M, 2)))},
             "split": [t(jax.random.normal(k, (M, 3))) for k in (ka, kb)]}
    tt = TLoop.Trainer(tc, TScene.Scene(tc, shuffle=True, seed=SEED),
                       state=convert.state_from_jax(tc, before, device="cpu"), seed=SEED,
                       device="cpu")
    tm = {k: float(v) for k, v in tt.run_iteration(IT, draws=draws).items()}
    return dict(before=before, after=after, jm=jm, tm=tm, tt=tt, tc=tc, jt=jt, jc=jc)


def test_mesh_iteration_metrics_match_jax(mesh_run):
    """Every loss term and PSNR rel 1e-5 (test_torch_train.py's limit); the
    mesh's size and every other capacity counter exactly; no mesh overflow,
    no non-finite gradient.  The raster's per-tile overflow (entries past
    K) within 1e-3: this messy first mesh puts ~5,600 past the cap, and its
    vertices differ from JAX's by ~1e-6 (DPSR's sums), so a face whose
    screen box ends on a tile edge can bin into one tile more or fewer."""
    jm, tm = mesh_run["jm"], mesh_run["tm"]
    assert set(tm) == set(jm)
    for k in ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss",
              "img_psnr", "mesh_psnr", "psr_min", "psr_max", "normal_norm"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]), k
    for k in ("mesh_n_verts", "mesh_n_faces", "mesh_overflow", "splat_overflow",
              "splat_dup_overflow", "nonfinite_grad_leaves"):
        assert tm[k] == jm[k], k
    assert abs(tm["raster_overflow"] - jm["raster_overflow"]) <= 1e-3 * jm["raster_overflow"]
    assert jm["mesh_n_verts"] > 500 and jm["mesh_overflow"] == 0


def test_normal_init_and_densify_match_jax(mesh_run):
    """After the iteration: the alive mask exactly (the densify hits and the
    prune); every Gaussian leaf, which only the normal init and densify
    change on this iteration (skip_gaussian_update), abs 1e-4 for the
    normals (each a face's normalised edge cross product, from vertices
    that differ by ~1e-6: tests/test_torch_structural.py's limit) and 1e-5
    for the others (split children placed with the same draws); moments
    and statistics as JAX's (1e-6)."""
    got, want, before = mesh_run["tt"].state, mesh_run["after"], mesh_run["before"]
    alive = np.asarray(want.gs.alive)
    np.testing.assert_array_equal(got.gs.alive.numpy(), alive)
    assert alive.sum() != np.asarray(before.gs.alive).sum()        # densify changed the set
    for f in GaussianParams._fields:
        a, w = getattr(got.gp, f).numpy(), np.asarray(getattr(want.gp, f))
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-4 if f == "normal" else 1e-5, err_msg=f)
        for tree in ("g_mu", "g_nu"):
            np.testing.assert_allclose(getattr(getattr(got, tree), f).numpy(),
                                       np.asarray(getattr(getattr(want, tree), f)), rtol=0,
                                       atol=1e-6, err_msg=f"{tree}.{f}")
    assert np.abs(np.asarray(want.gp.normal)[alive]).sum(-1).min() > 0.5   # normals were set
    for f in ("max_radii2d", "xyz_grad_accum", "denom"):
        assert not getattr(got.gs, f).any() and not np.asarray(getattr(want.gs, f)).any()
    assert int(got.step) == int(want.step) and int(got.g_count) == int(want.g_count)


def test_mesh_iteration_nets_match_jax(mesh_run):
    """Each net's Adam step (every net trains here): counts exactly; the
    parameters within 2·lr of JAX's, and abs 1e-6 where JAX's gradient is
    above a tenth of the leaf's largest (test_torch_train.py's limits)."""
    from test_torch_trainer import _jax_grads
    from dgmesh_torch.train import state as TState
    got, want, before, tc = (mesh_run[k] for k in ("tt", "after", "before", "tc"))
    got = got.state
    nlrs = TState.net_lrs(got.step.float() - 1, tc)
    for name in NETS:
        net = getattr(got.nets, name)
        lr = float(getattr(nlrs, name))
        assert int(getattr(got.net_opt, name).count) == 1
        for p, w, gj in zip(net.parameters(), convert.flax_leaves(net, getattr(want.nets, name)),
                            _jax_grads(before, want, net, name)):
            p = p.detach().numpy()
            assert np.abs(p - w).max() <= 2.0 * lr * 1.001 + 1e-7, name
            sure = np.abs(gj) > 0.1 * np.abs(gj).max()
            np.testing.assert_allclose(p[sure], w[sure], rtol=0, atol=1e-6, err_msg=name)


def test_test_pass_matches_jax(mesh_run, tmp_path):
    """run_testing on the state after the iteration, over the test view:
    the GS and mesh PSNR and SSIM rel 1e-4 of JAX's run_testing (no LPIPS
    weights here, so JAX reports none either; MS-SSIM needs 176 px and
    these views are 64); the view's images and mesh written."""
    from dgmesh_torch.eval.testing import run_testing as t_run
    from dgmesh_tpu.eval.testing import run_testing as j_run
    want = j_run(mesh_run["jc"], mesh_run["jt"], mesh_run["jt"].scene)
    got = t_run(mesh_run["tc"], mesh_run["tt"], mesh_run["tt"].scene, save_dir=str(tmp_path))
    assert set(got) == set(want) == {"psnr", "ssim", "mesh_psnr", "mesh_ssim", "fps"}
    for k in ("psnr", "ssim", "mesh_psnr", "mesh_ssim"):
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), k
    assert sorted(p.name for p in tmp_path.iterdir()) == ["mesh_000.ply", "mesh_000.png",
                                                          "render_000.png"]
