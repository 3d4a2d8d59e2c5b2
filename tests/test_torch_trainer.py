"""The port's Trainer against JAX's Trainer, consecutive iterations and
resume, on a generated dataset.

The dataset is the port's generate_mesh_dataset at 64² (4 training views,
subdiv 3); the config has the miniature capacities of
``__graft_entry__._tiny_cfg`` (grid 32, 512 Gaussian slots) with the
Pallas kernels on (interpret mode on the CPU), scan_steps 1, warm-up for 2
iterations and no mesh phase or densification (test_torch_trainer_mesh.py
has those).  JAX's Trainer makes the initial state; the port's Trainer
takes it across with convert.state_from_jax.  Blender data draws no time
noise, so these iterations draw nothing random.  JAX compiles two step
programs (warm and not).  Tolerances follow tests/test_torch_train.py's,
each stated with its reason.
"""

import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_parity_fixture import to_numpy

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch import convert  # noqa: E402
from dgmesh_torch.config import Config as TConfig  # noqa: E402
from dgmesh_torch.data import scene as TScene  # noqa: E402
from dgmesh_torch.data.synthetic_mesh import generate_mesh_dataset  # noqa: E402
from dgmesh_torch.models.gaussians import GaussianParams  # noqa: E402
from dgmesh_torch.train import checkpoint as TCk  # noqa: E402
from dgmesh_torch.train import loop as TLoop  # noqa: E402
from dgmesh_torch.train import state as TState  # noqa: E402
from dgmesh_tpu.config import Config as JConfig  # noqa: E402
from dgmesh_tpu.data import scene as JScene  # noqa: E402
from dgmesh_tpu.train import checkpoint as JCk  # noqa: E402
from dgmesh_tpu.train import loop as JLoop  # noqa: E402

torch.set_num_threads(1)

SEED = 6666
ITERS = 4                     # 1-2 warm-up, 3-4 the deformation on
NETS = ["deform", "deform_normal", "deform_back", "deform_back_normal", "appearance"]
METRICS = ("loss", "img_loss", "cycle_loss", "img_psnr")


def trainer_configs(data, **opt):
    """The JAX and port configs of these tests: _tiny_cfg's capacities,
    Pallas on, the schedule in ``opt``."""
    out = []
    for C in (JConfig, TConfig):
        c = C()
        c.model.source_path, c.model.data_type = data, "finetune-nerf"
        c.model.is_blender, c.model.grid_res, c.model.sh_degree = True, 32, 1
        c.model.gaussian_ratio, c.model.eval = 1.2, True
        o = c.optimization
        o.iterations, o.warm_up, o.dpsr_sig = 100, 3, 2.0
        o.dpsr_iter = o.densify_from_iter = o.densify_until_iter = 100
        for k, v in opt.items():
            setattr(o, k, v)
        t = c.tpu
        t.max_gaussians, t.max_gaussians_per_tile, t.max_dup = 512, 64, 1 << 12
        t.max_verts, t.max_faces = 16384, 32768
        t.max_faces_per_tile, t.max_face_dup, t.mr_cull_backface = 1024, 1 << 16, True
        t.use_pallas, t.scan_steps, t.occ_res = True, 1, 16
        out.append(c)
    return out


def dataset(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trainer_data"))
    generate_mesh_dataset(d, n_frames=4, width=64, height=64, n_test=1, subdiv=3, device="cpu")
    return d


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's Trainer for ITERS iterations (its state before each and its
    metrics), its checkpoint after iteration 3; and the port's Trainer
    from JAX's initial state over the same iterations."""
    data = dataset(tmp_path_factory)
    jc, tc = trainer_configs(data)
    jt = JLoop.Trainer(jc, JScene.Scene(jc, shuffle=True, seed=SEED), seed=SEED)
    ck = str(tmp_path_factory.mktemp("jax_ckpt"))
    states, jm = [to_numpy(jt.state)], []
    for it in range(1, ITERS + 1):
        jm.append({k: float(v) for k, v in jt.run_iteration(it).items()})
        states.append(to_numpy(jt.state))
        if it == 3:
            JCk.save_checkpoint(jt.state, ck, 3)
    tscene = TScene.Scene(tc, shuffle=True, seed=SEED)
    tt = TLoop.Trainer(tc, tscene, state=convert.state_from_jax(tc, states[0], device="cpu"),
                       seed=SEED, device="cpu")
    tm = [{k: float(v) for k, v in tt.run_iteration(it).items()} for it in range(1, ITERS + 1)]
    return dict(jt=jt, jc=jc, tc=tc, tscene=tscene, states=states, jm=jm, tt=tt, tm=tm, ck=ck)


def test_initial_state_matches_jax(run):
    """The port's own initial state from the scene (the capacity subsample
    from np.random.default_rng(seed), the kNN scales, the opacity, the DPSR
    frame) is JAX's: positions, colours, opacity and the alive mask exactly;
    log-scales abs 1e-5 (kNN distances in another summation order)."""
    own = TLoop.Trainer(run["tc"], run["tscene"], seed=SEED, device="cpu").state
    want = run["states"][0]
    for f in ("xyz", "f_dc", "f_rest", "opacity", "rotation", "normal"):
        np.testing.assert_array_equal(getattr(own.gp, f).numpy(), getattr(want.gp, f), err_msg=f)
    np.testing.assert_allclose(own.gp.scaling.numpy(), want.gp.scaling, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(own.gs.alive.numpy(), want.gs.alive)
    assert int(own.gs.alive.sum()) == 256          # 20,000 points subsampled to half of 512
    np.testing.assert_allclose(own.gs.gaussian_center.numpy(), want.gs.gaussian_center,
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(float(own.gs.gaussian_scale), float(want.gs.gaussian_scale),
                               rtol=1e-6)


def test_camera_order_matches_jax_over_three_epochs(run):
    n = len(run["tscene"].train_cameras)
    got = [run["tt"].next_camera_idx(it) for it in range(1, 3 * n + 1)]
    want = [run["jt"].next_camera_idx(it) for it in range(1, 3 * n + 1)]
    assert got == want and sorted(got[:n]) == list(range(n)) and got[:n] != got[n:2 * n]


def _jax_grads(before, after, tree, name=None):
    """JAX's gradient of a step from its Adam first moments:
    (mu_after - 0.9 mu_before) / 0.1."""
    if name is None:
        return {f: (np.asarray(getattr(after.g_mu, f)) - 0.9 * np.asarray(getattr(before.g_mu, f)))
                / 0.1 for f in GaussianParams._fields}
    mb = convert.flax_leaves(tree, getattr(before.net_opt, name).mu)
    ma = convert.flax_leaves(tree, getattr(after.net_opt, name).mu)
    return [(a - 0.9 * b) / 0.1 for a, b in zip(ma, mb)]


def _hold_state(got, before, after, cfg, step_tol):
    """A port state after a run of iterations against JAX's: every Gaussian
    leaf and net parameter within 2·lr of JAX's (Adam's first steps move an
    element with a near-zero gradient by ~±lr either way, as in
    test_torch_train.py); where JAX's last gradient is well above its
    noise (a hundredth of the leaf's largest for the Gaussians, a tenth for
    the nets, as there) within max(step_tol, 1e-4·lr): Adam's step is
    lr·m̂/√v̂, so gradients that agree to ~1e-4 move it by ~1e-4·lr, and
    the rotation group's rate is 0.1; the counts exactly."""
    assert int(got.step) == int(after.step) and int(got.g_count) == int(after.g_count)
    lrs = TState.gaussian_group_lrs(got.step - 1, cfg)
    g = _jax_grads(before, after, None)
    for f in GaussianParams._fields:
        a, w = getattr(got.gp, f).numpy(), np.asarray(getattr(after.gp, f))
        assert np.abs(a - w).max() <= 2.0 * float(getattr(lrs, f)) * 1.001 + 1e-7, f
        sure = np.abs(g[f]) > 1e-2 * np.abs(g[f]).max()
        tol = max(step_tol, 1e-4 * float(getattr(lrs, f)))
        np.testing.assert_allclose(a[sure], w[sure], rtol=0, atol=tol, err_msg=f)
    nlrs = TState.net_lrs(got.step.float() - 1, cfg)
    for name in NETS:
        net = getattr(got.nets, name)
        lr = float(getattr(nlrs, name))
        for p, w, gj in zip(net.parameters(), convert.flax_leaves(net, getattr(after.nets, name)),
                            _jax_grads(before, after, net, name)):
            p = p.detach().numpy()
            assert np.abs(p - w).max() <= 2.0 * lr * 1.001 + 1e-7, name
            sure = np.abs(gj) > 0.1 * np.abs(gj).max()
            np.testing.assert_allclose(p[sure], w[sure], rtol=0, atol=max(step_tol, 1e-4 * lr),
                                       err_msg=name)
        assert int(getattr(got.net_opt, name).count) == int(getattr(after.net_opt, name).count)


def test_consecutive_iterations_match_jax(run):
    """The port's Trainer over iterations 1-4 (two warm-up, two with the
    deformation and the cycle loss on, whose first step starts from the
    zero-initialised heads): each iteration's loss terms and PSNR rel 1e-5
    of JAX's, the capacity counters exactly; the state after the four
    within _hold_state's limits, 1e-5 where the gradient is sure (four
    chained steps of test_torch_train.py's 1e-6)."""
    for it, (jm, tm) in enumerate(zip(run["jm"], run["tm"]), 1):
        assert set(tm) == set(jm), it
        for k in METRICS:
            if k in jm:
                assert abs(tm[k] - jm[k]) <= 1e-5 * abs(jm[k]) + 1e-9, (it, k)
        for k in ("splat_overflow", "splat_dup_overflow", "nonfinite_grad_leaves", "n_alive"):
            assert tm[k] == jm[k], (it, k)
    assert run["jm"][3]["cycle_loss"] > 0             # the deformation moved at iteration 4
    _hold_state(run["tt"].state, run["states"][ITERS - 1], run["states"][ITERS], run["tc"], 1e-5)


@pytest.mark.parametrize("it", range(1, ITERS + 1))
def test_each_iteration_from_jax_state_matches_jax(run, it):
    """Iteration ``it`` from JAX's own state before it (the trainer's
    camera, flags, batch and learning rates for that iteration alone): the
    loss terms rel 1e-5, the state within _hold_state's limits, 1e-6 where
    the gradient is sure (test_torch_train.py's one-step limit)."""
    tt = run["tt"]
    tr = TLoop.Trainer(run["tc"], run["tscene"], seed=SEED, device="cpu",
                       state=convert.state_from_jax(run["tc"], run["states"][it - 1], device="cpu"))
    tr._batch_cache = tt._batch_cache
    m = {k: float(v) for k, v in tr.run_iteration(it).items()}
    for k in METRICS:
        if k in run["jm"][it - 1]:
            assert abs(m[k] - run["jm"][it - 1][k]) <= 1e-5 * abs(run["jm"][it - 1][k]), k
    _hold_state(tr.state, run["states"][it - 1], run["states"][it], run["tc"], 1e-6)


def test_resume_from_jax_msgpack(run):
    """JAX's checkpoint after iteration 3 (flax's state_3.msgpack; no .pt
    beside it) read by the port's load_checkpoint without flax or msgpack:
    every leaf of JAX's state exactly; and the port's next iteration from
    it matches JAX's iteration 4 (loss terms rel 1e-5, the state within
    _hold_state's one-step limits)."""
    files = os.listdir(os.path.join(run["ck"], "checkpoint"))
    assert files == ["state_3.msgpack"]
    st = TCk.load_checkpoint(run["tc"], run["ck"], device="cpu")
    want = convert.state_from_jax(run["tc"], run["states"][3], device="cpu")
    for tree in ("gp", "gs", "g_mu", "g_nu"):
        for a, b in zip(getattr(st, tree), getattr(want, tree)):
            assert torch.equal(a, b), tree
    for name in NETS:
        for a, b in zip(getattr(st.nets, name).parameters(), getattr(want.nets, name).parameters()):
            assert torch.equal(a, b), name
        oa, ob = getattr(st.net_opt, name), getattr(want.net_opt, name)
        assert int(oa.count) == int(ob.count) == (1 if name in ("deform", "deform_back") else 0)
        assert all(torch.equal(a, b) for a, b in zip(oa.mu + oa.nu, ob.mu + ob.nu))
    assert int(st.step) == 3 and int(st.g_count) == 3
    tr = TLoop.Trainer(run["tc"], run["tscene"], state=st, seed=SEED, device="cpu")
    m = {k: float(v) for k, v in tr.run_iteration(4).items()}
    for k in METRICS:
        assert abs(m[k] - run["jm"][3][k]) <= 1e-5 * abs(run["jm"][3][k]), k
    _hold_state(tr.state, run["states"][3], run["states"][4], run["tc"], 1e-6)


def test_msgpack_reader_against_flax(run, monkeypatch):
    """The port's decoder gives flax.serialization.msgpack_restore's tree
    (every array equal, the same dtypes), also for arrays that flax splits
    into chunks."""
    import flax.serialization as fser
    state = run["jt"].state
    for chunk in (None, 1 << 12):
        if chunk:
            monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", chunk)
        blob = fser.to_bytes(state)
        got = TCk.flax_msgpack_restore(blob)
        want = fser.msgpack_restore(blob)
        gl, gt = jax.tree_util.tree_flatten(got)
        wl, wt = jax.tree_util.tree_flatten(want)
        assert gt == wt and len(gl) > 50
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == np.asarray(b).dtype
    assert b"__msgpack_chunked_array__" in blob


def test_port_checkpoint_round_trip_is_exact(run, tmp_path):
    """save_checkpoint then load_checkpoint: every leaf, net parameter,
    moment and count bit for bit; the reference's PLY and one file per net
    written beside it."""
    st = run["tt"].state
    TCk.save_checkpoint(st, str(tmp_path), ITERS)
    back = TCk.load_checkpoint(run["tc"], str(tmp_path), device="cpu")
    for tree in ("gp", "gs", "g_mu", "g_nu"):
        for a, b in zip(getattr(back, tree), getattr(st, tree)):
            assert torch.equal(a, b) and a.dtype == b.dtype, tree
    for name in NETS:
        for a, b in zip(getattr(back.nets, name).parameters(), getattr(st.nets, name).parameters()):
            assert torch.equal(a, b), name
        oa, ob = getattr(back.net_opt, name), getattr(st.net_opt, name)
        assert torch.equal(oa.count, ob.count)
        assert all(torch.equal(a, b) for a, b in zip(oa.mu + oa.nu, ob.mu + ob.nu))
        assert (tmp_path / name / f"iteration_{ITERS}" / f"{name}.pt").exists()
    assert torch.equal(back.step, st.step) and torch.equal(back.g_count, st.g_count)
    assert (tmp_path / "point_cloud" / f"iteration_{ITERS}" / "point_cloud.ply").exists()
    assert TCk.search_max_iteration(str(tmp_path / "checkpoint")) == ITERS


# --- the tripwires ------------------------------------------------------------------

def _tripwire_trainer(run):
    return TLoop.Trainer(run["tc"], run["tscene"], state=run["tt"].state, seed=SEED,
                         device="cpu")


def _checkpoints(d):
    return sorted(os.listdir(os.path.join(d, "checkpoint")))


@pytest.mark.parametrize("case", ["non-finite loss", "empty mesh"])
def test_tripwire_halts_on_a_dead_step(run, tmp_path, case):
    """A healthy check keeps the state as the last good one (a plain
    reference: the step is functional); a non-finite loss or an empty mesh
    in the mesh phase halts, checkpointing the last-good and the tripped
    state."""
    tr = _tripwire_trainer(run)
    d = str(tmp_path / "trip")
    tr._check_tripwires(100, {"loss": 1.0, "mesh_n_verts": 42}, d)
    assert tr._last_good_state is tr.state and not os.path.exists(d)
    tr.state = tr.state._replace(step=tr.state.step + 1)
    bad = ({"loss": float("nan"), "mesh_n_verts": 42} if case == "non-finite loss"
           else {"loss": 1.0, "mesh_n_verts": 0})
    with pytest.raises(TLoop.TrainingHalted, match=case):
        tr._check_tripwires(101, bad, d)
    assert _checkpoints(d) == [f"state_{101}.pt", f"state_{ITERS}.pt"]


def test_tripwire_halts_when_thr_is_pinned(run, tmp_path):
    """density_thres at its bound for thr_pin_checks consecutive checks
    halts; one check off the bound resets the streak."""
    tr = _tripwire_trainer(run)
    d = str(tmp_path / "pin")
    pinned = {"loss": 1.0, "mesh_n_verts": 42, "mesh_psnr": 25.0,
              "density_thres": TState.DENSITY_THRES_BOUND}
    for i in range(tr.thr_pin_checks - 1):
        tr._check_tripwires(100 + i, pinned, d)
    tr._check_tripwires(200, {**pinned, "density_thres": 0.1}, d)
    assert tr._thr_pinned_streak == 0
    for i in range(tr.thr_pin_checks - 1):
        tr._check_tripwires(300 + i, pinned, d)
    with pytest.raises(TLoop.TrainingHalted, match="pinned"):
        tr._check_tripwires(999, pinned, d)
    assert _checkpoints(d) == ["state_4.pt", "state_999.pt"]


def test_tripwire_halts_when_mesh_psnr_stays_flat(run, tmp_path):
    """mesh_psnr below the floor for psnr_flat_checks consecutive checks
    after the grace window halts; inside the window it does not count, and
    one healthy value resets the streak."""
    tr = _tripwire_trainer(run)
    d = str(tmp_path / "flat")
    flat = {"loss": 1.0, "mesh_n_verts": 42, "mesh_psnr": 15.0, "density_thres": 0.0}
    tr._check_tripwires(5000, flat, d)
    assert tr._psnr_low_streak == 0 and tr._mesh_first_iter == 5000
    it = 5000 + tr.mesh_grace_iters
    tr._check_tripwires(it, {**flat, "mesh_psnr": 25.0}, d)
    for i in range(tr.psnr_flat_checks - 1):
        tr._check_tripwires(it + 1 + i, flat, d)
    with pytest.raises(TLoop.TrainingHalted, match="not learning"):
        tr._check_tripwires(it + 999, flat, d)
    assert _checkpoints(d) == ["state_4.pt", f"state_{it + 999}.pt"]


def test_trainer_constants_are_jax(run):
    """The tripwires' cadence and thresholds are JAX's."""
    tr, jt = run["tt"], run["jt"]
    for k in ("tripwire_every", "thr_pin_eps", "thr_pin_checks", "psnr_flat_checks",
              "mesh_psnr_floor", "mesh_grace_iters"):
        assert getattr(tr, k) == getattr(jt, k), k
    np.testing.assert_array_equal(tr.bg, jt.bg)
