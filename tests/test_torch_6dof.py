"""The 6-DoF deformation head (``DeformNetwork(is_6dof=True)``) and its SE(3)
maps (dgmesh_torch/ops/rigid.py) against the JAX package's, and a 6-DoF
training step against JAX's.

θ = ‖w‖ has no gradient at w = 0 in JAX (jax.grad of jnp.linalg.norm is
NaN there); the port reproduces that NaN, and the step's sanitiser counts
and zeroes the same leaves on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, ge, perturb_flax_heads, port_batch, port_fixture, to_numpy

from dgmesh_torch import convert
from dgmesh_torch.models import mlp as TM
from dgmesh_torch.ops import rigid as TR
from dgmesh_torch.train import step as TStep

from dgmesh_tpu.models import mlp as JM
from dgmesh_tpu.ops import rigid as JR
from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)


def _rigid_inputs(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    theta = rng.uniform(-3.0, 3.0, size=(n, 1)).astype(np.float32)
    theta[::7] = 0.0                                     # rows with no rotation
    S = np.concatenate([w, rng.normal(size=(n, 3)).astype(np.float32)], -1)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    return w, theta, S, xyz


def test_rigid_maps_match_jax():
    """skew, exp_so3, exp_se3 and the point transform: abs 1e-6."""
    w, theta, S, xyz = _rigid_inputs(np.random.default_rng(0))
    tw, tt, tS, tx = (torch.tensor(a) for a in (w, theta, S, xyz))
    pairs = [(TR.skew(tw), JR.skew(w)), (TR.exp_so3(tw, tt), JR.exp_so3(w, theta)),
             (TR.exp_se3(tS, tt), JR.exp_se3(S, theta)),
             (TR.se3_transform_points(tx, tS, tt), JR.se3_transform_points(xyz, S, theta))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_rigid_transform_gradients_match_jax():
    """d/d(xyz, S, θ) of a random linear function of the moved points, rows
    with θ = 0 included: within 1e-5 of each gradient's largest value."""
    rng = np.random.default_rng(1)
    _, theta, S, xyz = _rigid_inputs(rng)
    g = rng.normal(size=xyz.shape).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(JR.se3_transform_points(a, b, c) * g),
                    argnums=(0, 1, 2))(xyz, S, theta)
    ins = [torch.tensor(a, requires_grad=True) for a in (xyz, S, theta)]
    (TR.se3_transform_points(*ins) * torch.tensor(g)).sum().backward()
    for x, w in zip(ins, want):
        w = np.asarray(w)
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def _head(zero_w=False, seed=0):
    """JAX's 6-DoF DeformNetwork (blender timenet, normal head), its flax
    parameters (the offset heads given noise; with ``zero_w`` the w Dense
    all zero, so θ = 0 on every row) and the port's net with them."""
    net = JM.DeformNetwork(is_blender=True, with_normal=True, is_6dof=True)
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(96, 3)).astype(np.float32) * 0.4
    t = np.full((96, 1), 0.3, np.float32)
    params = to_numpy(net.init(jax.random.PRNGKey(seed), xyz, t))
    for name in ("Dense_4", "Dense_5", "Dense_6"):      # rot, scale, normal: zero-initialised
        d = params["params"][name]
        d["kernel"] = rng.normal(0, 1e-2, d["kernel"].shape).astype(np.float32)
    if zero_w:
        params["params"]["Dense_2"] = {k: np.zeros_like(v)
                                       for k, v in params["params"]["Dense_2"].items()}
    tnet = TM.DeformNetwork(is_blender=True, with_normal=True, is_6dof=True)
    convert.load_flax_params(tnet, params)
    return net, params, tnet, xyz, t, rng


def test_head_names_follow_flax():
    """The 6-DoF net's flax tree: Dense_0/1 the timenet, MLPTrunk_0, Dense_2
    w, Dense_3 v, then the rotation, scale and normal heads."""
    net, params, tnet, *_ = _head()
    assert set(params["params"]) == {"MLPTrunk_0"} | {f"Dense_{i}" for i in range(7)}
    layers = convert._flax_layers(tnet, params)
    assert layers[-5][0] is tnet.head_w and layers[-4][0] is tnet.head_v
    assert layers[-3][0] is tnet.head_rot and layers[-1][0] is tnet.head_normal
    assert tnet.head_w.weight.abs().max() > 0           # flax's default init, not zero


@pytest.mark.parametrize("zero_w", [False, True], ids=["live", "theta0"])
def test_head_forward_and_backward_match_jax(zero_w):
    """The four outputs within 1e-6 of their largest value; each parameter's
    gradient of a random linear function of them within 1e-4 of its largest
    value.  With the w Dense zero (θ = 0 on every row) JAX's gradient is
    NaN in exactly the leaves where the port's is, the rest as above."""
    net, params, tnet, xyz, t, rng = _head(zero_w)
    outs = net.apply(params, xyz, t)
    gs = [rng.normal(size=np.shape(o)).astype(np.float32) for o in outs]
    tout = tnet(torch.tensor(xyz), torch.tensor(t))
    for got, want in zip(tout, outs):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30))

    def f(p):
        return sum(jnp.sum(o * g) for o, g in zip(net.apply(p, xyz, t), gs))

    want = convert.flax_leaves(tnet, to_numpy(jax.grad(f)(params)))
    sum((o * torch.tensor(g)).sum() for o, g in zip(tout, gs)).backward()
    n_nan = 0
    for p, w in zip(tnet.parameters(), want):
        got = p.grad.numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(w))
        n_nan += int(np.isnan(w).any())
        ok = ~np.isnan(w)
        if ok.any() and np.abs(w[ok]).max() > 0:
            np.testing.assert_allclose(got[ok], w[ok], rtol=0, atol=1e-4 * np.abs(w[ok]).max())
    assert (n_nan > 0) == zero_w


@pytest.fixture(scope="module")
def steps():
    """JAX's and the port's 6-DoF train_step from one state, twice: as made
    (offset heads given noise) and with the deform net's w Dense zeroed, so
    every row's θ is 0 and JAX's gradient is NaN there."""
    cfg, img = ge._tiny_cfg(grid_res=16, max_g=512, img=32)
    cfg.model.is_6dof = True
    cfg.tpu.use_pallas = True
    for k, v in dict(ROOMY, max_verts=4096, max_faces=8192).items():
        setattr(cfg.tpu, k, v)
    ctx, state, batch = ge._make_state_and_batch(cfg, img)
    nets = perturb_flax_heads(state.nets, np.random.default_rng(5), 1e-3)
    flags = JStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                            anchor=False, sh_degree=1)
    tflags = TStep.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                             sh_degree=1)
    jstep = jax.jit(lambda st, b: JStep.train_step(ctx, st, b, jax.random.PRNGKey(0), flags))
    out = {}
    for case in ("live", "theta0"):
        if case == "theta0":
            d = nets.deform["params"]["Dense_2"]
            nets.deform["params"]["Dense_2"] = {k: np.zeros_like(v) for k, v in d.items()}
        st = state._replace(nets=jax.tree.map(jnp.asarray, nets))
        new, m = jstep(st, batch)
        tcfg, tctx, tst, _ = port_fixture(cfg, img, st)
        tnew, tm = TStep.train_step(tctx, tst, port_batch(batch), tflags)
        old = [q.detach().clone() for q in tst.nets.deform.parameters()]
        out[case] = dict(want=to_numpy(m), got=tm, new=to_numpy(new), tnew=tnew, old=old)
    return out


@pytest.mark.parametrize("case", ["live", "theta0"])
def test_6dof_train_step_matches_jax(steps, case):
    """Every loss term within 1e-5 relative (the mask term exactly), the mesh
    size and the non-finite gradient leaf count equal; with θ = 0 the
    sanitiser zeroes the same NaN leaves on both sides (count > 0), and those
    leaves of the deform net keep their parameters on both sides."""
    want, got = steps[case]["want"], steps[case]["got"]
    for k in ("loss", "cycle_loss", "mesh_img_loss", "laplacian_loss", "img_loss"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    assert float(got["mask_loss"]) == float(want["mask_loss"])
    for k in ("mesh_n_verts", "mesh_n_faces", "nonfinite_grad_leaves"):
        assert int(got[k]) == int(want[k]), k
    assert int(want["mesh_n_verts"]) > 100
    assert (int(want["nonfinite_grad_leaves"]) > 0) == (case == "theta0")
    # the leaves the sanitiser zeroed keep their parameters (Adam from zero
    # moments with a zero gradient): the same leaves on both sides
    tnet = steps[case]["tnew"].nets.deform
    jleaves = convert.flax_leaves(tnet, steps[case]["new"].nets.deform)
    kept_t, kept_j = [], []
    for p, w, o in zip(tnet.parameters(), jleaves, steps[case]["old"]):
        assert np.isfinite(p.detach().numpy()).all() and np.isfinite(w).all()
        kept_t.append(bool(torch.equal(p.detach(), o)))
        kept_j.append(bool(np.array_equal(w, o.numpy())))
    assert kept_t == kept_j
    assert any(kept_t) or case == "live"
