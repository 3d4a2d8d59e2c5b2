"""Gradients of the port's training-path ops against the JAX package's.

Each op gets the same inputs (the miniature fixture's state, or numpy with a
seed) and the same random cotangent weights on both sides; JAX runs its
Pallas kernels in interpret mode and their analytic backwards.  Each
tolerance is stated with its reason.  Also here: the two fault repairs
(``jnp.clip``'s half gradient at a bound, for extract_mesh's ``p01`` and
marching tets' ``t``), the losses and the schedules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_fixture import ROOMY, jax_fixture, port_batch, port_fixture, t, to_numpy

from dgmesh_torch import schedules as TSch
from dgmesh_torch.ops import laplacian as TLap
from dgmesh_torch.ops import losses as TL
from dgmesh_torch.ops import marching_tets as TMT
from dgmesh_torch.ops import mesh_raster as TMR
from dgmesh_torch.ops import splat as TS
from dgmesh_torch.train import step as TStep

from dgmesh_tpu import schedules as JSch
from dgmesh_tpu.models import gaussians as JG
from dgmesh_tpu.ops import laplacian as JLap
from dgmesh_tpu.ops import losses as JL
from dgmesh_tpu.ops import marching_tets as JMT
from dgmesh_tpu.ops import mesh_raster as JMR
from dgmesh_tpu.ops import splat as JS
from dgmesh_tpu.train import step as JStep

torch.set_num_threads(1)


def close(got, want, rel, floor, what=""):
    """|got − want| ≤ rel·max|want| + floor, elementwise."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + floor,
                               err_msg=what)


def tgrad(fn, *xs):
    xs = [t(x).requires_grad_(True) for x in xs]
    out = fn(*xs)
    return out.detach(), torch.autograd.grad(out, xs, allow_unused=True)


@pytest.fixture(scope="module")
def fg():
    cfg, img, ctx, state, batch = jax_fixture(head_std=1e-3, seed=3, **ROOMY)
    tcfg, tctx, tstate, _ = port_fixture(cfg, img, state)
    flags = JStep.StepFlags(mesh=True, use_normal=True, sh_degree=1)
    d = jax.jit(lambda st, b: JStep._deform_all(ctx, st.nets, st.gp.xyz, b.fid, 0.0,
                                                flags))(state, batch)
    mesh = jax.jit(lambda st, d: JStep.extract_mesh(ctx, st.gp, st.gs, d[0], d[3],
                                                    freeze_pos=False))(state, d)
    return dict(cfg=cfg, img=img, ctx=ctx, state=state, batch=batch, tctx=tctx,
                tstate=tstate, tbatch=port_batch(batch), d=to_numpy(d), mesh=to_numpy(mesh))


# --- splat -------------------------------------------------------------------

def test_splat_render_grads_match_jax(fg):
    """d(Σ W·render + Σ Wa·alpha) for means, scales, rotations, opacities,
    SH and the screen offset: rel 1e-4 of each input's largest gradient +
    abs 1e-9 (kernel-2 twin vs the Pallas backward: sums over K and P in
    other orders; the per-Gaussian scatter of the tile rows in other orders)."""
    st, d = fg["state"], fg["d"]
    gp, gs = st.gp, st.gs
    xs = (np.asarray(gp.xyz) + d[0], np.asarray(JG.get_scaling(gp)) + d[2],
          np.asarray(JG.get_rotation(gp)) + d[1], np.asarray(JG.get_opacity(gp)),
          np.asarray(JG.get_features(gp)), np.zeros((gp.xyz.shape[0], 2), np.float32))
    alive = np.asarray(gs.alive)
    rng = np.random.default_rng(0)
    w_img = rng.normal(size=(3, fg["img"], fg["img"])).astype(np.float32)
    w_a = rng.normal(size=(fg["img"], fg["img"])).astype(np.float32)
    jcam, bg = fg["batch"].cam, jnp.zeros(3)

    def jloss(m, s, q, o, sh, so):
        out = JS.render(m, s, q, o, sh, jnp.asarray(alive), jcam, bg, fg["ctx"].splat_cfg,
                        sh_degree=1, screen_offset=so)
        return jnp.sum(out["render"] * w_img) + jnp.sum(out["alpha"] * w_a)

    want_v, want = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(6))))(*xs)

    def tloss(m, s, q, o, sh, so):
        out = TS.render(m, s, q, o, sh, t(alive, torch.bool), fg["tbatch"].cam,
                        torch.zeros(3), fg["tctx"].splat_cfg, 1, screen_offset=so)
        return (out["render"] * t(w_img)).sum() + (out["alpha"] * t(w_a)).sum()

    got_v, got = tgrad(tloss, *xs)
    assert abs(float(got_v) - float(want_v)) <= 1e-4 * abs(float(want_v))
    for name, g, w in zip(("means3d", "scales", "rotations", "opacities", "shs",
                           "screen_offset"), got, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        close(g, w, 1e-4, 1e-9, name)


# --- mesh raster ---------------------------------------------------------------

def test_render_mesh_grads_match_jax(fg):
    """d(Σ W·rgb + Σ Wm·st_mask) for the vertices and their colours, with
    the shared ``tri_w`` gather: rel 1e-4 of the largest gradient + abs 1e-9
    (kernel-4 twin vs the Pallas backward, sums in other orders)."""
    m = fg["mesh"]
    rng = np.random.default_rng(1)
    col = rng.random(m.verts.shape).astype(np.float32)
    H = W = fg["img"]
    w_rgb = rng.normal(size=(H, W, 3)).astype(np.float32)
    w_m = rng.normal(size=(H, W)).astype(np.float32)
    b = fg["batch"]
    faces, fvalid = np.asarray(m.faces), np.asarray(m.face_valid)

    jfaces, jfvalid = jnp.asarray(faces), jnp.asarray(fvalid)

    def jloss(v, c):
        out = JMR.render_mesh(v, jfaces, jfvalid, c, b.mesh_pose, b.mesh_proj, jnp.zeros(3),
                              fg["ctx"].mr_cfg, want_soft=True, tri_w=v[jfaces])
        return jnp.sum(out["rgb"] * w_rgb) + jnp.sum(out["st_mask"] * w_m)

    want_v, want = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(m.verts, col)
    tb = fg["tbatch"]
    tf = t(faces, torch.long)

    def tloss(v, c):
        out = TMR.render_mesh(v, tf, t(fvalid, torch.bool), c, tb.mesh_pose, tb.mesh_proj,
                              torch.zeros(3), fg["tctx"].mr_cfg, want_soft=True, tri_w=v[tf])
        return (out["rgb"] * t(w_rgb)).sum() + (out["st_mask"] * t(w_m)).sum()

    got_v, got = tgrad(tloss, m.verts, col)
    assert abs(float(got_v) - float(want_v)) <= 1e-4 * abs(float(want_v))
    for name, g, w in zip(("verts", "vtx_color"), got, want):
        assert np.abs(np.asarray(w)).max() > 0, name
        close(g, w, 1e-4, 1e-9, name)


# --- DPSR and marching tets -------------------------------------------------------

def test_dpsr_grads_match_jax(fg):
    """d(Σ W·φ) for the points and the normals: rel 1e-4 + abs 1e-9 (the
    FFTs and the index_add_ splat sum in other orders than JAX's slab
    matmuls; φ itself agrees to ~1e-7 relative)."""
    gp, gs = fg["state"].gp, fg["state"].gs
    p01 = np.clip((np.asarray(gp.xyz) - np.asarray(gs.gaussian_center))
                  / np.asarray(gs.gaussian_scale) / 2 + 0.5, 1e-6, 1 - 1e-6)
    nrm = np.asarray(gp.normal) + fg["d"][3]
    alive = np.asarray(gs.alive)
    w = np.random.default_rng(2).normal(size=(32, 32, 32)).astype(np.float32)
    want = jax.jit(jax.grad(lambda p, n: jnp.sum(fg["ctx"].dpsr(p, n, jnp.asarray(alive)) * w),
                            argnums=(0, 1)))(p01, nrm)
    _, got = tgrad(lambda p, n: (fg["tctx"].dpsr(p, n, t(alive, torch.bool)) * t(w)).sum(),
                   p01, nrm)
    for name, g, wnt in zip(("points", "normals"), got, want):
        assert np.abs(np.asarray(wnt)[alive]).max() > 0, name
        close(g, wnt, 1e-4, 1e-9, name)


def test_marching_tets_grads_match_jax(fg):
    """d(Σ W·verts) for the field: rel 1e-5 + abs 1e-9 (the same edge
    interpolation; the topology carries no gradient)."""
    gp, gs = fg["state"].gp, fg["state"].gs
    psr = np.asarray(jax.jit(lambda p, n: fg["ctx"].dpsr(p, n, gs.alive))(
        (gp.xyz - gs.gaussian_center) / gs.gaussian_scale / 2 + 0.5, gp.normal))
    cfgj, cfgt = fg["ctx"].mt_cfg, fg["tctx"].mt_cfg
    w = np.random.default_rng(3).normal(size=(cfgj.max_verts, 3)).astype(np.float32)
    want = jax.jit(jax.grad(lambda f: jnp.sum(JMT.marching_tets(f, cfgj).verts * w)))(psr)
    _, (got,) = tgrad(lambda f: (TMT.marching_tets(f, cfgt).verts * t(w)).sum(), psr)
    assert np.count_nonzero(np.asarray(want)) > 100
    close(got, want, 1e-5, 1e-9, "psr")


def _bound_field(value):
    """A 4³ field, positive on the x = 3 face and negative elsewhere, with
    the lattice point (2,0,0) set to ``value``: its edge to (3,0,0) crosses
    the surface."""
    f = -np.ones((4, 4, 4), np.float32)
    f[3] = 1.0
    f[2, 0, 0] = value
    return f


def test_marching_tets_t_takes_the_half_gradient_at_a_bound():
    """Fault repair.  Where φ is exactly 0 at a lattice point, the edge
    interpolation t = φ0/(φ0 − φ1) sits exactly on its clip bound 0; JAX's
    jnp.clip passes half the gradient there (torch.clamp would pass all of
    it).  The port must give JAX's value: abs 1e-6, and half of what the
    same vertex gets just inside the bound (rel 1e-3)."""
    cfg = TMT.MTConfig(res=4, max_verts=256, max_faces=512, max_cubes=256)
    jcfg = JMT.MTConfig(res=4, max_verts=256, max_faces=512, max_cubes=256)
    f0 = _bound_field(0.0)
    w = np.zeros((256, 3), np.float32)
    w[:, 0] = 1.0                                   # Σ x of every vertex

    def port_grad(f):
        _, (g,) = tgrad(lambda x: (TMT.marching_tets(x, cfg).verts * t(w)).sum(), f)
        return g.numpy()[2, 0, 0]

    want = float(jax.grad(lambda x: jnp.sum(JMT.marching_tets(x, jcfg).verts * w))(f0)[2, 0, 0])
    got = port_grad(f0)
    inside = port_grad(_bound_field(-1e-4))
    assert want != 0.0
    assert abs(got - want) <= 1e-6
    assert abs(got - 0.5 * inside) <= 1e-3 * abs(inside)


def test_extract_mesh_p01_takes_the_half_gradient_at_a_bound(fg):
    """Fault repair.  A live point whose normalised coordinate p01 lands
    exactly on the clip bound 1 − SMALL: JAX's jnp.clip passes half the
    gradient there (torch.clamp would pass all of it).  With the frame at
    centre 0 / scale 1, x = 1 − 17·2⁻²³ gives p01 = 1 − 17·2⁻²⁴ =
    float32(1 − 1e-6) exactly.  d(Σ W·verts)/d xyz of that point: the
    port's equals JAX's (rel 1e-3, the DPSRs differ at ~1e-7), and is half
    of what the point gets one step inside the bound (rel 2e-2: the field
    moves with the point)."""
    st, ctx, tctx = fg["state"], fg["ctx"], fg["tctx"]
    x_b = np.float32(1.0 - 17 * 2.0 ** -23)
    assert np.float32(np.float32(x_b / np.float32(1.0)) / np.float32(2.0)) + np.float32(0.5) \
        == np.float32(1.0 - 1e-6)
    xyz = np.asarray(st.gp.xyz).copy()
    xyz[0] = [x_b, 0.1, 0.05]
    gs = st.gs._replace(gaussian_center=jnp.zeros(3), gaussian_scale=jnp.asarray(1.0))
    gp = st.gp._replace(xyz=jnp.asarray(xyz))
    zeros = np.zeros_like(xyz)
    w = np.random.default_rng(4).normal(size=(ctx.mt_cfg.max_verts, 3)).astype(np.float32)

    def jgrad(x):
        return np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(JStep.extract_mesh(
            ctx, gp._replace(xyz=x), gs, zeros, zeros, False).verts * w)))(x))[0, 0]

    tgs = fg["tstate"].gs._replace(gaussian_center=torch.zeros(3),
                                   gaussian_scale=torch.tensor(1.0))

    def pgrad(x):
        _, (g,) = tgrad(lambda x: (TStep.extract_mesh(
            tctx, fg["tstate"].gp._replace(xyz=x), tgs, torch.zeros(xyz.shape),
            torch.zeros(xyz.shape)).verts * t(w)).sum(), x)
        return float(g[0, 0])

    want, got = jgrad(xyz), pgrad(xyz)
    inside = xyz.copy()
    inside[0, 0] = np.float32(x_b - np.float32(2.0 ** -23))
    full = pgrad(inside)
    assert abs(want) > 1e-6
    assert abs(got - want) <= 1e-3 * abs(want)
    assert abs(got - 0.5 * full) <= 2e-2 * abs(full)


def test_extract_mesh_freeze_pos_stops_the_position_gradient(fg):
    """freeze_pos: no gradient reaches the point positions through the mesh,
    the normals still get theirs."""
    tgp, tgs = fg["tstate"].gp, fg["tstate"].gs
    w = t(np.random.default_rng(6).normal(size=(fg["ctx"].mt_cfg.max_verts, 3)))
    xyz, nrm = tgp.xyz.clone().requires_grad_(True), tgp.normal.clone().requires_grad_(True)
    m = TStep.extract_mesh(fg["tctx"], tgp._replace(xyz=xyz, normal=nrm), tgs,
                           torch.zeros_like(xyz), torch.zeros_like(xyz), freeze_pos=True)
    gx, gn = torch.autograd.grad((m.verts * w).sum(), (xyz, nrm), allow_unused=True)
    assert gx is None or not gx.any()
    assert gn.abs().max() > 0


# --- Laplacian ----------------------------------------------------------------------

def test_laplacian_value_and_grads_match_jax(fg):
    """Value rel 1e-5; d tri and d verts rel 1e-5 + abs 1e-12 (the same
    scatter-adds in other orders; the analytic backward on both sides)."""
    m = fg["mesh"]
    faces, fvalid = np.asarray(m.faces), np.asarray(m.face_valid)
    verts = np.asarray(m.verts)
    tri = verts[faces]
    want_v, want = jax.value_and_grad(
        lambda tr, v: JLap.laplacian_uniform_tri(tr, v, jnp.asarray(faces), jnp.asarray(fvalid)),
        argnums=(0, 1))(jnp.asarray(tri), jnp.asarray(verts))
    got_v, got = tgrad(lambda tr, v: TLap.laplacian_uniform_tri(
        tr, v, t(faces, torch.long), t(fvalid, torch.bool)), tri, verts)
    assert abs(float(got_v) - float(want_v)) <= 1e-5 * abs(float(want_v))
    for name, g, w in zip(("tri", "verts"), got, want):
        assert np.abs(np.asarray(w)).max() > 0
        close(g, w, 1e-5, 1e-12, name)


def test_laplacian_through_the_shared_gather_matches_autograd():
    """laplacian_uniform_tri(verts[faces], verts, ...) through both its
    arguments against plain autograd of the same forward: rel 1e-5."""
    rng = np.random.default_rng(5)
    verts = t(rng.normal(size=(40, 3)).astype(np.float32)).requires_grad_(True)
    faces = torch.as_tensor(rng.integers(0, 30, (60, 3)))
    fvalid = torch.as_tensor(rng.random(60) < 0.8)
    (g1,) = torch.autograd.grad(TLap.laplacian_uniform_tri(verts[faces], verts, faces, fvalid),
                                verts)
    loss, *_ = TLap._laplacian_tri_fwd(verts[faces], verts, faces, fvalid)
    (g2,) = torch.autograd.grad(loss, verts)
    torch.testing.assert_close(g1, g2, rtol=0, atol=1e-5 * float(g2.abs().max()))


# --- losses -------------------------------------------------------------------------

def _images(seed, shape=(3, 64, 64)):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "ssim", "ms_ssim", "psnr", "image_loss"])
def test_losses_value_and_grad_match_jax(name):
    """Value rel 1e-5, d img rel 1e-4 + abs 1e-10 (SAME-padded separable
    convolutions with the same 11-tap window, summed in other orders)."""
    img, gt = _images(7)
    extra = (0.2,) if name == "image_loss" else ()
    jf, tf = getattr(JL, name), getattr(TL, name)
    want_v, want = jax.value_and_grad(lambda x: jf(x, jnp.asarray(gt), *extra))(img)
    got_v, (got,) = tgrad(lambda x: tf(x, t(gt), *extra), img)
    assert abs(float(got_v) - float(want_v)) <= 1e-5 * abs(float(want_v))
    close(got, want, 1e-4, 1e-10, name)


def test_l1_has_zero_subgradient_at_zero_like_jax():
    """Where img == gt exactly, both give gradient 0 (the straight-through
    mask relies on it); elsewhere ±1/n."""
    img, gt = _images(8, (1, 8, 8))
    gt[0, :4] = img[0, :4]
    want = np.asarray(jax.grad(lambda x: JL.l1_loss(x, jnp.asarray(gt)))(img))
    _, (got,) = tgrad(lambda x: TL.l1_loss(x, t(gt)), img)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0, :4].any() and np.abs(want[0, 4:]).min() > 0


# --- schedules ---------------------------------------------------------------------

def test_time_noise_only_for_non_blender_data():
    """Blender data draws no cycle time noise; other data draws two normal
    samples from the given generator, scaled by time_interval ×
    linear_noise(step) (reference train.py:160-162, 200-202)."""
    from types import SimpleNamespace
    batch = SimpleNamespace(time_interval=torch.tensor(0.05))
    step = torch.tensor(300.0)
    blender = SimpleNamespace(cfg=SimpleNamespace(model=SimpleNamespace(is_blender=True)))
    assert TStep._time_noise(blender, batch, step, None) == (0.0, 0.0)
    other = SimpleNamespace(cfg=SimpleNamespace(model=SimpleNamespace(is_blender=False)))
    n1, n2 = TStep._time_noise(other, batch, step, torch.Generator().manual_seed(3))
    z = torch.randn((2,), generator=torch.Generator().manual_seed(3))
    mag = 0.05 * float(JSch.linear_noise(300))
    assert abs(float(n1) - float(z[0]) * mag) <= 1e-6 * mag
    assert abs(float(n2) - float(z[1]) * mag) <= 1e-6 * mag


@pytest.mark.parametrize("step", [0, 1, 500, 7_000, 29_999, 45_000])
def test_schedules_match_jax(step):
    """expon_lr (with and without the delay) and linear_noise: rel 1e-6."""
    for args, kw in (((1.6e-4, 1.6e-6), dict(max_steps=30_000)),
                     ((1.6e-4, 1.6e-6), dict(lr_delay_steps=1000, lr_delay_mult=0.01,
                                             max_steps=40_000)),
                     ((0.0, 1e-3), {})):
        want = float(JSch.expon_lr(step, *args, **kw))
        got = float(TSch.expon_lr(step, *args, **kw))
        assert abs(got - want) <= 1e-6 * abs(want), (args, kw)
    want, got = float(JSch.linear_noise(step)), float(TSch.linear_noise(step))
    assert abs(got - want) <= 1e-6 * abs(want)
