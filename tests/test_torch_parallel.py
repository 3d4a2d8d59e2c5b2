"""The port's sharded ops (dgmesh_torch/parallel) against its single-device
ops, at n = 2 and n = 4 gloo ranks on the CPU; the sharded marching tets
against JAX's own sharded function; the guards.

The inputs come from the port's miniature state (graft_entry: grid 32, 512
Gaussian slots, 256 live, 64², 16 tiles), so at n = 4 two ranks hold no
live Gaussian.  The splat's K (64) and the raster's (32) truncate tiles,
which the merge must reproduce.  Each rank count is spawned once for the
module (tests/torch_parallel_ranks.py::ops_rank); torch runs one thread in
every rank.  Each op's gradient is that of a fixed random linear function
of its outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from torch_parity_fixture import ROOT  # noqa: F401  (puts the repo on sys.path)
import torch_parallel_ranks as R

from dgmesh_torch import graft_entry as GE
from dgmesh_torch.models import gaussians as G
from dgmesh_torch.ops import mesh_raster as MR
from dgmesh_torch.ops import splat
from dgmesh_torch.ops.dpsr import DPSR
from dgmesh_torch.ops.marching_tets import MTConfig, marching_tets
from dgmesh_torch.parallel import sharding as SH
from dgmesh_torch.parallel.sharded_dpsr import dpsr_sharded
from dgmesh_torch.parallel.sharded_mt import marching_tets_sharded
from dgmesh_torch.train.step import StepContext

from dgmesh_tpu.ops.marching_tets import MTConfig as JMTConfig
from dgmesh_tpu.parallel.sharded_mt import marching_tets_sharded as jax_mt_sharded

torch.set_num_threads(1)
NS = (2, 4)
MT_CFG = MTConfig(res=32, max_verts=16384, max_faces=32768, max_cubes=16384)
MT16 = MTConfig(res=16, max_verts=2048, max_faces=4096, max_cubes=2048)


def _field16():
    g = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    q = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - 0.28      # a torus: cross-slab topology
    return (np.sqrt(q ** 2 + (z - 0.5) ** 2) - 0.12).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    cfg, img = GE._tiny_cfg()
    ctx, state, batch = GE._make_state_and_batch(cfg, img, "cpu")
    gp, gs = state.gp, state.gs
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    sc = ctx.splat_cfg
    sp = dict(means3d=gp.xyz, scales=G.get_scaling(gp), quats=G.get_rotation(gp),
              opacities=G.get_opacity(gp), shs=G.get_features(gp), alive=gs.alive,
              cam=batch.cam, bg=torch.tensor([0.2, 0.3, 0.4]), cfg=sc, sh_degree=1,
              g_img=rand(3, img, img), g_alpha=rand(img, img))
    p01 = ((gp.xyz - gs.gaussian_center) / gs.gaussian_scale / 2.0 + 0.5).clamp(1e-6, 1 - 1e-6)
    op = DPSR((32,) * 3, sig=2.0, div_mode="splat")
    dp = dict(points=p01, normals=gp.normal, valid=gs.alive, op=op, g_phi=rand(32, 32, 32))
    phi = op(p01, gp.normal, gs.alive)
    phi = phi * torch.sign(phi[0, 0, 0]) - gp.density_thres
    m = marching_tets(phi, MT_CFG)
    verts = torch.where(m.vert_valid[:, None],
                        (m.verts * 2.0 - 1.0) * gs.gaussian_scale + gs.gaussian_center, 0.0)
    mc = ctx.mr_cfg._replace(max_per_tile=32, max_dup=1 << 16, cull_backface=True)
    mr = dict(verts=verts, faces=m.faces, face_valid=m.face_valid,
              vtx_color=torch.tensor(rng.uniform(size=(verts.shape[0], 3)).astype(np.float32)),
              pose=batch.mesh_pose, proj=batch.mesh_proj, bg=torch.tensor([0.1, 0.2, 0.3]),
              cfg=mc, g_rgb=rand(img, img, 3), g_soft=rand(img, img))
    mt = dict(phi=phi.detach(), cfg=MT_CFG, g_verts=rand(MT_CFG.max_verts, 3))
    return dict(splat=sp, dpsr=dp, mr=mr, mt=mt)


@pytest.fixture(scope="module")
def runs(inputs):
    return {n: SH.spawn(R.ops_rank, n, "gloo", "cpu", args=(inputs,), threads=1)
            for n in NS}


@pytest.fixture(scope="module")
def single(inputs):
    """The single-device ops and gradients of the same linear functions."""
    out = {}
    s = inputs["splat"]
    names = ("means3d", "scales", "quats", "opacities", "shs")
    leaves = {k: s[k].clone().requires_grad_(True) for k in names}
    r = splat.render(*[leaves[k] for k in names], s["alive"], s["cam"], s["bg"], s["cfg"],
                     s["sh_degree"])
    ((r["render"] * s["g_img"]).sum() + (r["alpha"] * s["g_alpha"]).sum()).backward()
    pre = splat.preprocess(*[s[k] for k in names], s["alive"], s["cam"], s["cfg"], 1)
    out["splat"] = dict(render=r["render"].detach(), alpha=r["alpha"].detach(),
                        radii=r["radii"].detach(), visibility=r["visibility"], aux=r["aux"],
                        tile_idx=splat.bin_gaussians(pre, s["cfg"])[0],
                        grads={k: leaves[k].grad for k in names})
    m = inputs["mr"]
    verts = m["verts"].clone().requires_grad_(True)
    color = m["vtx_color"].clone().requires_grad_(True)
    r = MR.render_mesh(verts, m["faces"], m["face_valid"], color, m["pose"], m["proj"],
                       m["bg"], m["cfg"], want_soft=True)
    ((r["rgb"] * m["g_rgb"]).sum() + (r["soft_mask"] * m["g_soft"]).sum()).backward()
    out["mr"] = dict(rgb=r["rgb"].detach(), mask=r["mask"], soft=r["soft_mask"].detach(),
                     face_id=r["face_id"], aux=r["aux"], g_verts=verts.grad, g_color=color.grad)
    d = inputs["dpsr"]
    pts = d["points"].clone().requires_grad_(True)
    nrm = d["normals"].clone().requires_grad_(True)
    phi = d["op"](pts, nrm, d["valid"])
    (phi * d["g_phi"]).sum().backward()
    out["dpsr"] = dict(phi=phi.detach(), g_points=pts.grad, g_normals=nrm.grad)
    t = inputs["mt"]
    phi = t["phi"].clone().requires_grad_(True)
    mt = marching_tets(phi, t["cfg"])
    nv = int(mt.n_verts)
    (mt.verts[:nv] * t["g_verts"][:nv]).sum().backward()
    out["mt"] = dict(mesh=mt._replace(verts=mt.verts.detach()), g_phi=phi.grad)
    return out


def _close(got, want, rel, what):
    """|got - want| <= rel * max|want| (and both finite)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3g} of the largest |value| > {rel}"


# --- the collectives -----------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_collectives_and_their_transposes(runs, n):
    """Each rank r takes x_r (2n×3) and a loss Σ <op(x_r), w_r>: the values are
    the collectives' and x_r's gradient their transposes' (shard_map's:
    all_gather ↔ reduce-scatter, psum_scatter ↔ all_gather, all_to_all and
    ppermute their reverse, psum ↔ psum), exactly up to float sums."""
    c = runs[n][0]["collectives"]
    m = 2 * n

    def blocks(t):                       # (n·2n, 3) gathered → per rank (2n, 3)
        return list(t.reshape(n, m, 3))

    x, gx = {k: blocks(v["x"]) for k, v in c.items()}, {k: blocks(v["grad"]) for k, v in c.items()}
    ag = c["all_gather"]
    w = ag["w"].reshape(n, n * m, 3)
    for r in range(n):
        assert torch.allclose(ag["y"].reshape(n, n * m, 3)[r], torch.cat(x["all_gather"]))
        assert torch.allclose(gx["all_gather"][r], w.sum(0)[r * m:(r + 1) * m], atol=1e-6)
    ps = c["psum_scatter"]
    total = sum(x["psum_scatter"])                          # (2n, 3)
    w = ps["w"].reshape(n, 2, 3)
    for r in range(n):
        assert torch.allclose(ps["y"].reshape(n, 2, 3)[r], total[2 * r:2 * r + 2], atol=1e-6)
        assert torch.allclose(gx["psum_scatter"][r], w.reshape(m, 3))
    a2 = c["all_to_all"]
    w = a2["w"].reshape(n, n, 2, 3)
    xs = torch.stack(x["all_to_all"]).reshape(n, n, 2, 3)   # [source, dest block]
    for r in range(n):
        assert torch.equal(a2["y"].reshape(n, n, 2, 3)[r], xs[:, r])
        assert torch.equal(gx["all_to_all"][r].reshape(n, 2, 3), w[:, r])
    pp = c["ppermute"]
    w = pp["w"].reshape(n, m, 3)
    for r in range(n):
        assert torch.equal(pp["y"].reshape(n, m, 3)[r], x["ppermute"][(r - 1) % n])
        assert torch.equal(gx["ppermute"][r], w[(r + 1) % n])
    pu = c["psum"]
    w = pu["w"].reshape(n, m, 3)
    for r in range(n):
        assert torch.allclose(pu["y"].reshape(n, m, 3)[r], sum(x["psum"]), atol=1e-6)
        assert torch.allclose(gx["psum"][r], w.sum(0), atol=1e-6)


# --- splat -----------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_splat_tile_lists_exact(runs, single, n):
    """Every tile's merged list, row for row, is the single-device list (K
    truncates here: the overflow counter is > 0 and equal)."""
    want = single["splat"]
    for rank in runs[n]:
        got = rank["splat"]
        assert torch.equal(got["tile_idx"], want["tile_idx"])
        assert int(got["aux"]["tile_overflow"]) == int(want["aux"]["tile_overflow"]) > 0
        assert int(got["aux"]["num_duplicates"]) == int(want["aux"]["num_duplicates"])
        assert int(got["aux"]["dup_overflow"]) == int(want["aux"]["dup_overflow"]) == 0


@pytest.mark.parametrize("n", NS)
def test_splat_image_and_gradients(runs, single, n):
    """The image and alpha: the same rows composited in the same order, so
    equal to 1e-6 of their largest value; radii and visibility exact; each
    Gaussian input's gradient within 1e-5 of its largest value (the rows'
    gradients reach each Gaussian in another order) — an n-fold gradient
    would be off by (n-1)x."""
    want = single["splat"]
    got = runs[n][0]["splat"]
    _close(got["render"], want["render"], 1e-6, "render")
    _close(got["alpha"], want["alpha"], 1e-6, "alpha")
    assert torch.equal(got["radii"], want["radii"])
    assert torch.equal(got["visibility"], want["visibility"])
    assert want["grads"]["means3d"].abs().max() > 0
    for k, g in want["grads"].items():
        if g.abs().max() == 0:          # the state's round Gaussians: no d quats
            assert got["grads"][k].abs().max() <= 1e-9, k
        else:
            _close(got["grads"][k], g, 1e-5, f"d {k}")


# --- mesh raster ----------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_mesh_raster_matches_single_device(runs, single, n):
    """rgb, hard mask and soft mask within 1e-6 of their largest value (the
    same rows, shaded in the same order); the face ids the same faces; the
    counters equal (K truncates); the vertex and colour gradients, summed
    over the ranks, within 1e-5."""
    want = single["mr"]
    got = runs[n][0]["mr"]
    for k in ("rgb", "mask", "soft"):
        _close(got[k], want[k], 1e-6, k)
    assert torch.equal(got["face_id"], want["face_id"])   # a whole array: same numbering
    for k in ("tile_overflow", "num_duplicates", "dup_overflow"):
        assert int(got["aux"][k]) == int(want["aux"][k]), k
    assert int(want["aux"]["tile_overflow"]) > 0
    _close(got["g_verts"], want["g_verts"], 1e-5, "d verts")
    _close(got["g_color"], want["g_color"], 1e-5, "d vtx_color")


# --- DPSR -------------------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_dpsr_matches_single_device(runs, single, n):
    """The field within 1e-5 of its largest |value| (rfftn against rfft2, an
    exchange and fft along x: the same transform in another order); the
    point and normal gradients within 1e-4 of their largest value."""
    want = single["dpsr"]
    got = runs[n][0]["dpsr"]
    _close(got["phi"], want["phi"], 1e-5, "phi")
    _close(got["g_points"], want["g_points"], 1e-4, "d points")
    _close(got["g_normals"], want["g_normals"], 1e-4, "d normals")


# --- marching tets ------------------------------------------------------------------

def _tris(verts, faces, valid):
    """A mesh's triangles as a sorted set of corner coordinates."""
    t = verts[faces[valid]].reshape(-1, 3, 3).numpy()
    order = np.lexsort((t[..., 2], t[..., 1], t[..., 0]), axis=-1)
    t = np.take_along_axis(t, order[..., None], axis=1).reshape(-1, 9)
    return t[np.lexsort(t.T[::-1])]


@pytest.mark.parametrize("n", NS)
def test_marching_tets_matches_single_device(runs, single, n):
    """The valid vertices of the stitched blocks are the single-device
    vertices, in order and bit for bit; the triangles the same set; counts
    equal, no overflow; the field's gradient equal to 1e-6 of its largest
    value."""
    want = single["mt"]["mesh"]
    got = runs[n][0]["mt"]["whole"]
    nv, nf = int(want.n_verts), int(want.n_faces)
    assert int(got.n_verts) == nv > 1000 and int(got.n_faces) == nf
    assert int(got.overflow) == 0 == int(want.overflow)
    assert torch.equal(got.verts[got.vert_valid], want.verts[:nv])
    np.testing.assert_array_equal(_tris(got.verts, got.faces, got.face_valid),
                                  _tris(want.verts, want.faces, want.face_valid))
    _close(runs[n][0]["mt"]["g_phi"], single["mt"]["g_phi"], 1e-6, "d phi")


def test_sharded_mt_matches_jax_sharded():
    """At n = 2 on grid 16: each rank's block (its faces in the stitched
    numbering, validity, counts exactly; its vertices to one float32 ulp of
    their [0, 1] range) equals JAX's sharded function's block on a
    2-device mesh."""
    t = dict(phi=torch.tensor(_field16()), cfg=MT16)
    got = SH.spawn(R.mt16_rank, 2, "gloo", "cpu", args=(t,), threads=1)
    cfg = JMTConfig(res=16, max_verts=2048, max_faces=4096, max_cubes=2048)
    jmesh = Mesh(np.asarray(jax.devices()[:2]), ("gauss",))
    want = jax.jit(lambda p: jax_mt_sharded(jmesh, p, cfg))(jnp.asarray(_field16()))
    verts = np.concatenate([g.verts.numpy() for g in got])
    faces = np.concatenate([g.faces.numpy() for g in got])
    vv = np.concatenate([g.vert_valid.numpy() for g in got])
    fv = np.concatenate([g.face_valid.numpy() for g in got])
    np.testing.assert_array_equal(vv, np.asarray(want.vert_valid))
    np.testing.assert_array_equal(fv, np.asarray(want.face_valid))
    # XLA rounds the edge interpolation's last division otherwise: one ulp
    np.testing.assert_allclose(verts[vv], np.asarray(want.verts)[vv], rtol=0, atol=2e-7)
    np.testing.assert_array_equal(faces[fv], np.asarray(want.faces)[fv])
    assert int(got[0].n_verts) == int(want.n_verts) > 100
    assert int(got[0].n_faces) == int(want.n_faces)
    assert int(got[0].overflow) == int(want.overflow) == 0


# --- guards --------------------------------------------------------------------------

def test_guards():
    """N % n, F % n and res % n raise, as JAX's sharded guards do; so do a
    Gaussian capacity the mesh does not divide, NCCL on the CPU and two
    NCCL ranks on one card."""
    mesh3 = SH.DeviceMesh(0, 3, "gloo", "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        SH.rows_of(torch.zeros(512, 3), mesh3)               # N % n
    with pytest.raises(ValueError, match="not divisible"):
        SH.rows_of(torch.zeros(8192, 3, dtype=torch.long), mesh3)   # F % n
    op = DPSR((32,) * 3, sig=2.0, div_mode="splat")
    pts = torch.zeros(6, 3)
    with pytest.raises(ValueError, match="not divisible"):
        dpsr_sharded(mesh3, op, pts, pts, torch.ones(6, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        dpsr_sharded(SH.DeviceMesh(0, 2, "gloo", "cpu"), DPSR((32,) * 3, div_mode="spectral"),
                     pts, pts, torch.ones(6, dtype=torch.bool))
    with pytest.raises(ValueError, match="not divisible"):
        marching_tets_sharded(mesh3, torch.zeros(32, 32, 32), MT_CFG)
    cfg, img = GE._tiny_cfg()
    with pytest.raises(ValueError, match="not divisible"):
        StepContext(cfg, img, img, device="cpu", device_mesh=mesh3)
    with pytest.raises(ValueError, match="nccl"):
        SH.spawn(R.mt16_rank, 2, "nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        SH.spawn(R.mt16_rank, 2, "mpi", "cpu")


# --- the tile offset of kernels 1-4 (their twins here) -----------------------------

@pytest.mark.parametrize("which", ["composite", "composite_bwd", "shade", "shade_bwd"])
def test_twins_with_tile0_match_the_sliced_full_twin(which):
    """Tiles [T/2, T) launched alone with tile0 = T/2 give the same bits as
    the same tiles of the whole launch, forward and backward (a rank
    composites and shades its own block of tiles this way)."""
    import chip_smoke as CS
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.ops import splat_kernels as SK
    T, K, tiles_x, tile = 8, 40, 4, 16
    h = T // 2
    rng = np.random.default_rng(11)
    if which.startswith("composite"):
        a = torch.tensor(CS.random_composite_attrs(rng, T, K, tiles_x, tile))
        fwd = lambda x, **k: SK.composite_tiles(x, tiles_x, tile, tile, residuals=True, **k)  # noqa: E731
    else:
        a = torch.tensor(CS.random_shade_attrs(rng, T, K, tiles_x, tile))
        fwd = lambda x, **k: MK.shade_tiles(x, tiles_x, tile, tile, 1.0, residuals=True, **k)  # noqa: E731
    full, half = fwd(a), fwd(a[h:].contiguous(), tile0=h)
    if not which.endswith("bwd"):
        for x, y in zip(full, half):
            assert torch.equal(x[h:], y)
        assert any(bool((x[h:] != x[:h]).any()) for x in full)   # the offset matters
        return
    g, g2 = (torch.tensor(x) for x in CS.cotangents(rng, T, tile * tile))
    if which == "composite_bwd":
        d_full = SK.composite_bwd(a, g, g2, tiles_x, tile, tile, full[0], full[2])
        d_half = SK.composite_bwd(a[h:].contiguous(), g[h:].contiguous(), g2[h:].contiguous(),
                                  tiles_x, tile, tile, half[0], half[2], tile0=h)
    else:
        d_full = MK.shade_bwd(a, g, g2, tiles_x, tile, tile, 1.0, *full[4:])
        d_half = MK.shade_bwd(a[h:].contiguous(), g[h:].contiguous(), g2[h:].contiguous(),
                              tiles_x, tile, tile, 1.0, *half[4:], tile0=h)
    assert torch.equal(d_full[h:], d_half) and d_half.abs().max() > 0
