"""The port's backward-kernel twins against the JAX Pallas backward kernels
(interpret mode), and the autograd Functions that pair them with the forward
kernels.

``composite_bwd_ref`` and ``shade_bwd_ref`` are the plain PyTorch twins of
the port's CUDA kernels ``csrc/composite_bwd.cu`` and ``csrc/shade_bwd.cu``;
on the CPU the wrappers run them.  The same seeded rows and cotangents go
through ``composite_bwd_pallas`` / ``shade_bwd_pallas``.  The shade rows hold
built ties (a pixel centre on a vertex, on an edge's interior, on the
symmetry axis of a triangle; uu exactly 0 and 1) where the Pallas kernel
splits gradients in half.  The CUDA kernels themselves are held against
these twins on the GPU by chip_smoke.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (seeded rows shared with the GPU check)
from dgmesh_torch.ops import mesh_raster_kernels as MK  # noqa: E402
from dgmesh_torch.ops import splat_kernels as SK  # noqa: E402
from dgmesh_tpu.ops.mesh_raster_pallas import shade_bwd_pallas, shade_tiles_pallas  # noqa: E402
from dgmesh_tpu.ops.splat_pallas import composite_bwd_pallas, composite_tiles_pallas  # noqa: E402

torch.set_num_threads(1)

TILES_X, TILE = 2, 16
T, P = 4, 256               # 2 x 2 tiles of 16 x 16
# composite_bwd_ref given the forward's rgb and S against without them, per
# lane group, relative to the group's largest |value|: the suffix's total is
# g_rgb.rgb in place of the last inclusive sum, the same float32 sum of up
# to K terms in another order, and its rounding reaches d alpha divided by
# 1 - alpha (>= 0.01); at most 5e-6 on these rows
TOL_RES_REL, TOL_RES_ABS = 5e-5, 1e-6


def _residual_gap(got, want):
    """Worst per-group |got - want| over its tolerance (<= 1 agrees)."""
    worst = 0.0
    for lanes in chip_smoke.COMPOSITE_GROUPS.values():
        w = want[..., lanes].double()
        err = float((got[..., lanes].double() - w).abs().max())
        worst = max(worst, err / (TOL_RES_ABS + TOL_RES_REL * float(w.abs().max())))
    return worst


def _area(a):
    return ((a[..., 2] - a[..., 0]) * (a[..., 5] - a[..., 1])
            - (a[..., 3] - a[..., 1]) * (a[..., 4] - a[..., 0]))


@pytest.mark.parametrize("seed,K", [(0, 32), (1, 48)])
def test_composite_bwd_twin_matches_pallas(seed, K):
    """Every lane, abs 1e-5 + rel 1e-5 of the lane's largest value (the
    Pallas kernel takes its prefix sums by tril matmul, the twin by cumsum);
    invalid rows and lanes 9-15 exactly 0 on both sides."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.random_composite_attrs(rng, T, K, TILES_X, TILE)
    g, ga = chip_smoke.cotangents(rng, T, P)
    want = np.asarray(composite_bwd_pallas(jnp.asarray(a), jnp.asarray(g), jnp.asarray(ga),
                                           TILES_X, TILE, TILE, interpret=True))
    got = SK.composite_bwd_ref(torch.as_tensor(a), torch.as_tensor(g), torch.as_tensor(ga),
                               TILES_X, TILE, TILE).numpy()
    for lane in range(16):
        tol = 1e-5 + 1e-5 * np.abs(want[..., lane]).max()
        np.testing.assert_allclose(got[..., lane], want[..., lane], rtol=0, atol=tol,
                                   err_msg=f"lane {lane}")
    invalid = a[..., 9] < 0.5
    assert invalid.any() and not got[invalid].any() and not want[invalid].any()
    assert not got[..., 9:].any()
    assert np.abs(got[..., :9]).max(axis=(0, 1)).min() > 1e-3     # every lane is live


@pytest.mark.parametrize("case,K", chip_smoke.COMPOSITE_EDGE_SHAPES)
def test_composite_bwd_twin_matches_pallas_at_edge_shapes(case, K):
    """The twin against the Pallas kernel at the shapes chip_smoke.py also
    holds the CUDA kernel to (one row, a ragged K, a tile with no valid row,
    every row valid, valid rows interleaved with invalid ones, rows at the
    0.99 clamp, a pixel whose T falls to 0), over 2 tiles: every lane within
    abs 1e-5 + rel 1e-5 of the lane's largest value; invalid rows and lanes
    9-15 exactly 0; and the twin given the forward's residuals within the
    residual bound of itself without them."""
    rng = np.random.default_rng(K)
    nt = chip_smoke.COMPOSITE_EDGE_TILES
    a = chip_smoke.composite_edge_attrs(rng, case, K, nt, TILES_X, TILE)
    g, ga = chip_smoke.cotangents(rng, nt, P)
    want = np.asarray(composite_bwd_pallas(jnp.asarray(a), jnp.asarray(g), jnp.asarray(ga),
                                           TILES_X, TILE, TILE, interpret=True))
    at, gt, gat = (torch.as_tensor(x) for x in (a, g, ga))
    got = SK.composite_bwd_ref(at, gt, gat, TILES_X, TILE, TILE)
    for lane in range(16):
        tol = 1e-5 + 1e-5 * np.abs(want[..., lane]).max()
        np.testing.assert_allclose(got.numpy()[..., lane], want[..., lane], rtol=0, atol=tol,
                                   err_msg=f"lane {lane}")
    rgb, _, S = SK.composite_tiles_ref(at, TILES_X, TILE, TILE, residuals=True)
    assert _residual_gap(SK.composite_bwd_ref(at, gt, gat, TILES_X, TILE, TILE, rgb=rgb, S=S),
                         got) <= 1.0
    valid = a[..., 9] > 0.5
    assert not got.numpy()[~valid].any() and not want[~valid].any()
    assert not got.numpy()[..., 9:].any()
    assert np.abs(want[valid][:, :9]).max() > 0          # the valid rows carry gradient
    if case == "all invalid":
        assert not valid[0].any() and valid[1].any()
    elif case in ("one row", "all valid"):
        assert valid.all()
    elif case == "interleaved":
        assert not valid[:, 0::2].any() and valid[:, 1::2].all()
    elif case == "at the clamp":
        px, py = SK.tile_pixels(nt, TILES_X, TILE, TILE, 0.0, "cpu")
        dx, dy = at[..., 0:1] - px[:, None], at[..., 1:2] - py[:, None]
        power = (-0.5 * (at[..., 2:3] * dx * dx + at[..., 4:5] * dy * dy)
                 - at[..., 3:4] * dx * dy)
        raw = at[..., 5:6] * torch.exp(power)
        assert bool(((raw == SK.ALPHA_MAX) & torch.as_tensor(valid)[..., None]).any())
    elif case == "T to 0":
        assert bool((torch.exp(S) == 0).any())


@pytest.mark.parametrize("seed,K", [(0, 32), (1, 48)])
def test_composite_forward_residuals_agree_with_jax_forward(seed, K):
    """The forward twin's residual S against the Pallas forward (interpret
    mode): 1 - exp(S) is JAX's alpha within abs 1e-5 (the forward's own
    tolerance), and S is log(1 - alpha) of JAX's within (1e-5 + 1e-6) / (1 -
    alpha): that alpha's error through the logarithm's slope, where 1 -
    alpha >= 1e-4; rgb and alpha are the same bits with and without it."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.random_composite_attrs(rng, T, K, TILES_X, TILE)
    _, alpha_j = (np.asarray(x) for x in composite_tiles_pallas(
        jnp.asarray(a), TILES_X, TILE, TILE, interpret=True))
    out = SK.composite_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, residuals=True)
    plain = SK.composite_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE)
    assert torch.equal(out[0], plain[0]) and torch.equal(out[1], plain[1])
    S = out[2].numpy().astype(np.float64)
    alpha_j = alpha_j.reshape(T, P).astype(np.float64)
    np.testing.assert_allclose(1.0 - np.exp(S), alpha_j, rtol=0, atol=1e-5)
    keep = 1.0 - alpha_j >= 1e-4
    assert keep.mean() > 0.5 and (S < -1.0).any()
    gap = np.abs(S - np.log1p(-alpha_j))[keep]
    assert (gap <= (1e-5 + 1e-6) / (1.0 - alpha_j[keep])).all()


@pytest.mark.parametrize("case,K", [("random", 32), ("at the clamp", 32), ("T to 0", 64)])
def test_composite_bwd_twin_with_residuals(case, K):
    """composite_bwd_ref given the forward twin's rgb and S within the
    residual bound of itself without them; the wrapper with them on the CPU
    is that twin, and the autograd Function, which saves them, gives its
    bits."""
    rng = np.random.default_rng(K)
    a = (chip_smoke.random_composite_attrs(rng, T, K, TILES_X, TILE) if case == "random"
         else chip_smoke.composite_edge_attrs(rng, case, K, T, TILES_X, TILE))
    a = torch.as_tensor(a)
    g, ga = (torch.as_tensor(x) for x in chip_smoke.cotangents(rng, T, P))
    rgb, _, S = SK.composite_tiles_ref(a, TILES_X, TILE, TILE, residuals=True)
    want = SK.composite_bwd_ref(a, g, ga, TILES_X, TILE, TILE, rgb=rgb, S=S)
    assert _residual_gap(want, SK.composite_bwd_ref(a, g, ga, TILES_X, TILE, TILE)) <= 1.0
    assert torch.equal(SK.composite_bwd(a, g, ga, TILES_X, TILE, TILE, rgb, S), want)
    x = a.clone().requires_grad_(True)
    rgb2, alpha2 = SK.CompositeTiles.apply(x, TILES_X, TILE, TILE)
    (d,) = torch.autograd.grad((rgb2 * g).sum() + (alpha2 * ga).sum(), x)
    assert torch.equal(d, want)


@pytest.mark.parametrize("seed,K,sigma", [(0, 32, 1.0), (1, 40, 0.7)])
def test_shade_bwd_twin_matches_pallas_with_ties(seed, K, sigma):
    """Every lane, abs 1e-5 + rel 1e-5 of the lane's largest value, on rows
    with built ties (the half-gradient splits agree exactly, or the error
    would be half a row's term).  Slivers (|area| < AREA_MIN) put a and c
    ~1e-5 px apart: the gradient of the distance to that ~1e-5 px edge is
    ill-conditioned in float32 and moves with the rounding of each
    multiply-add (the JAX CPU backend fuses some), so on sliver rows lanes
    0, 1, 4 and 5 are left out here; the card check (chip_smoke.py) holds
    the kernel to the twin there, both without fused multiply-adds.
    Invalid rows and lanes 9, 19-23 exactly 0."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.shade_tie_attrs(rng, T, K, TILES_X, TILE)
    g, gs = chip_smoke.cotangents(rng, T, P)
    want = np.asarray(shade_bwd_pallas(jnp.asarray(a), jnp.asarray(g), jnp.asarray(gs),
                                       TILES_X, TILE, TILE, sigma, interpret=True))
    got = MK.shade_bwd_ref(torch.as_tensor(a), torch.as_tensor(g), torch.as_tensor(gs),
                           TILES_X, TILE, TILE, sigma).numpy()
    sliver = (np.abs(_area(a)) < 1e-4) & (a[..., 9] > 0.5)
    assert sliver.any()
    for lane in range(24):
        tol = 1e-5 + 1e-5 * np.abs(want[..., lane]).max()
        keep = ~sliver if lane in (0, 1, 4, 5) else np.ones_like(sliver)
        np.testing.assert_allclose(got[..., lane][keep], want[..., lane][keep], rtol=0,
                                   atol=tol, err_msg=f"lane {lane}")
    invalid = a[..., 9] < 0.5
    assert invalid.any() and not got[invalid].any() and not want[invalid].any()
    assert not got[..., [9, 19, 20, 21, 22, 23]].any()


def _nan_tile_holds(case, a, got, want, win):
    """Tile 0 of a NaN case (its NaN rows: every fifth from row 2).  Every
    NaN of the twin is one of JAX's.  JAX has more: its dense one-hot sums
    (win·b, win·colour over all rows) carry a row's NaN into every pixel
    and row of the tile through 0·NaN, where the twin (and the kernel)
    select the winner's terms, so the NaN stays with the row that holds it
    and the pixels it wins.  With a NaN corner or edge length the tile's
    soft sum is NaN in both, so every valid row's screen lanes are NaN in
    both; with a NaN colour, the twin's NaNs are lanes 0-8 of the NaN rows
    that win a pixel, nothing else."""
    got, want, valid = got[0], want[0], a[0, :, 9] > 0.5
    assert (np.isnan(want) | ~np.isnan(got)).all()
    nan_rows = np.zeros(len(valid), bool)
    nan_rows[2::5] = True
    if case == "NaN colour":
        wins = np.isin(np.arange(len(valid)), win[0])
        expect = np.zeros_like(got, bool)
        expect[nan_rows & wins, :9] = True
        assert (nan_rows & wins).any()
        np.testing.assert_array_equal(np.isnan(got), expect)
    else:
        assert np.isnan(got[valid][:, :6]).all() and np.isnan(want[valid][:, :6]).all()
        assert np.isfinite(got[:, 6:]).all()
    assert not got[~valid].any()


@pytest.mark.parametrize("case,K", chip_smoke.SHADE_EDGE_SHAPES)
def test_shade_bwd_twin_matches_pallas_at_edge_shapes(case, K):
    """The twin against the Pallas kernel at the shapes chip_smoke.py also
    holds the CUDA kernel to (one row, a ragged K, a tile with no valid row,
    every row valid, valid rows interleaved with invalid ones, pixels with
    no winner), over 2 tiles with built ties: every lane within abs 1e-5 +
    rel 1e-5 of the lane's largest value (lanes 0, 1, 4, 5 of sliver rows
    left out, as above); invalid rows and lanes 9, 19-23 exactly 0.  In the
    NaN cases tile 1 holds no NaN row and is held so; tile 0 by
    ``_nan_tile_holds``."""
    rng = np.random.default_rng(K)
    nt = chip_smoke.SHADE_EDGE_TILES
    a = chip_smoke.shade_edge_attrs(rng, case, K, nt, TILES_X, TILE)
    g, gs = chip_smoke.cotangents(rng, nt, P)
    want = np.asarray(shade_bwd_pallas(jnp.asarray(a), jnp.asarray(g), jnp.asarray(gs),
                                       TILES_X, TILE, TILE, 1.0, interpret=True))
    got = MK.shade_bwd_ref(torch.as_tensor(a), torch.as_tensor(g), torch.as_tensor(gs),
                           TILES_X, TILE, TILE, 1.0).numpy()
    if case in chip_smoke.SHADE_NAN_CASES:
        win = MK.shade_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, 1.0,
                                 residuals=True)[4].numpy()
        _nan_tile_holds(case, a, got, want, win)
        a, got, want = a[1:], got[1:], want[1:]
    valid = a[..., 9] > 0.5
    sliver = (np.abs(_area(a)) < 1e-4) & valid
    for lane in range(24):
        tol = 1e-5 + 1e-5 * np.abs(want[..., lane]).max()
        keep = ~sliver if lane in (0, 1, 4, 5) else np.ones_like(sliver)
        np.testing.assert_allclose(got[..., lane][keep], want[..., lane][keep], rtol=0,
                                   atol=tol, err_msg=f"lane {lane}")
    assert not got[~valid].any() and not want[~valid].any()
    assert not got[..., [9, 19, 20, 21, 22, 23]].any()
    assert np.abs(got[valid][:, :19]).max() > 0          # the valid rows carry gradient
    if case == "all invalid":
        assert not valid[0].any() and valid[1].any()
    elif case == "all valid":
        assert valid.all()
    elif case == "interleaved":
        assert not valid[:, 0::2].any() and valid[:, 1::2].all()
    elif case == "no winner":
        _, hard, _, _ = MK.shade_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, 1.0)
        assert (hard == 0).any(dim=1).all() and (hard == 1).any(dim=1).all()


@pytest.mark.parametrize("case,K", [c for c in chip_smoke.SHADE_EDGE_SHAPES
                                    if c[0] in chip_smoke.SHADE_NAN_CASES])
def test_shade_forward_twin_keeps_nan_rows_as_jax(case, K):
    """The forward twin against the Pallas forward on the NaN cases: tile 1
    (no NaN row) within 1e-5 with hard and fid exact, as everywhere; in
    tile 0 hard and fid exactly JAX's, the soft silhouette NaN exactly
    where JAX's is (every pixel with a NaN corner or edge length: the row's
    nearest-edge distance is NaN) and within 1e-5 elsewhere, and the rgb
    NaN only where JAX's is (JAX's win·b sums spread a row's NaN
    barycentrics over the tile; the twin's NaNs are the pixels whose winner
    has a NaN colour), within 1e-5 where both are finite."""
    rng = np.random.default_rng(K)
    nt = chip_smoke.SHADE_EDGE_TILES
    a = chip_smoke.shade_edge_attrs(rng, case, K, nt, TILES_X, TILE)
    want = [np.asarray(x).reshape(nt, P, -1) for x in shade_tiles_pallas(
        jnp.asarray(a), TILES_X, TILE, TILE, 1.0, interpret=True)]
    out = MK.shade_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, 1.0, residuals=True)
    got = [x.numpy().reshape(nt, P, -1) for x in out[:4]]
    for name, x, w in zip(("rgb", "hard", "soft", "fid"), got, want):
        both = np.isfinite(x) & np.isfinite(w)
        np.testing.assert_allclose(x[both], w[both], rtol=0, atol=1e-5, err_msg=name)
        assert (np.isnan(w) | ~np.isnan(x)).all(), name
        assert np.isfinite(x[1]).all() and np.isfinite(w[1]).all(), name
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(np.isnan(got[2]), np.isnan(want[2]))
    m = out[5].numpy()
    if case == "NaN colour":
        assert np.isfinite(got[2]).all()
        win = out[4].numpy()[0]
        nan_win = np.isin(win, np.arange(2, K, 5))
        assert nan_win.any()
        np.testing.assert_array_equal(np.isnan(got[0][0]).any(-1), nan_win)
    else:
        assert np.isnan(got[2][0]).all() and np.isnan(m[0]).all()
        assert np.isfinite(got[0]).all()


@pytest.mark.parametrize("seed,K", [(0, 32), (1, 40)])
def test_shade_forward_residuals_agree_with_jax_forward(seed, K):
    """The forward twin's residuals against the Pallas forward (interpret
    mode): the winner row's face id is JAX's fid (0 where no winner, -1 in
    win), and 1 - exp(M) is JAX's soft to rel 1e-6; the four outputs are the
    same bits with and without residuals."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.random_shade_attrs(rng, T, K, TILES_X, TILE)
    rgb_j, hard_j, soft_j, fid_j = (np.asarray(x) for x in shade_tiles_pallas(
        jnp.asarray(a), TILES_X, TILE, TILE, 1.0, interpret=True))
    out = MK.shade_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, 1.0, residuals=True)
    plain = MK.shade_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, 1.0)
    assert all(torch.equal(x, y) for x, y in zip(out[:4], plain))
    win, m = out[4].numpy(), out[5].numpy()
    assert win.dtype == np.int32 and (win >= 0).any() and (win == -1).any()
    fid = np.where(win >= 0, np.take_along_axis(a[..., 19], np.maximum(win, 0), 1), 0.0)
    np.testing.assert_array_equal(fid, fid_j.reshape(T, P))
    np.testing.assert_array_equal(win >= 0, hard_j.reshape(T, P) > 0.5)
    np.testing.assert_allclose(1.0 - np.exp(m), soft_j.reshape(T, P), rtol=1e-6, atol=0)


@pytest.mark.parametrize("case,K", [("ties", 32), ("all invalid", 40), ("no winner", 3)])
def test_shade_bwd_twin_with_residuals_is_bit_for_bit(case, K):
    """shade_bwd_ref given the forward twin's residuals (win, M) gives the
    same bits as without them, and the wrapper with them on the CPU is the
    twin; the autograd Function saves them for its backward."""
    rng = np.random.default_rng(K)
    a = (chip_smoke.shade_tie_attrs(rng, T, K, TILES_X, TILE) if case == "ties"
         else chip_smoke.shade_edge_attrs(rng, case, K, T, TILES_X, TILE))
    a = torch.as_tensor(a)
    g, gs = (torch.as_tensor(x) for x in chip_smoke.cotangents(rng, T, P))
    win, m = MK.shade_tiles_ref(a, TILES_X, TILE, TILE, 1.0, residuals=True)[4:]
    want = MK.shade_bwd_ref(a, g, gs, TILES_X, TILE, TILE, 1.0)
    assert torch.equal(MK.shade_bwd_ref(a, g, gs, TILES_X, TILE, TILE, 1.0, win=win, M=m), want)
    assert torch.equal(MK.shade_bwd(a, g, gs, TILES_X, TILE, TILE, 1.0, win, m), want)
    x = a.clone().requires_grad_(True)
    rgb, _, soft, _ = MK.ShadeTiles.apply(x, TILES_X, TILE, TILE, 1.0)
    (d,) = torch.autograd.grad((rgb * g).sum() + (soft * gs).sum(), x)
    assert torch.equal(d, want)


def test_shade_bwd_wrapper_checks_its_residuals():
    rng = np.random.default_rng(2)
    a = torch.as_tensor(chip_smoke.random_shade_attrs(rng, T, 8, TILES_X, TILE))
    g, gs = torch.zeros((T, P, 3)), torch.zeros((T, P))
    win, m = MK.shade_tiles_ref(a, TILES_X, TILE, TILE, 1.0, residuals=True)[4:]
    for bad in ((win, None), (None, m), (win.long(), m), (win, m.double()),
                (win[:, :-1], m), (win, m[:-1])):
        with pytest.raises(ValueError):
            MK.shade_bwd(a, g, gs, TILES_X, TILE, TILE, 1.0, *bad)


def test_shade_tie_rows_hold_the_ties():
    """The built rows do produce the tie cases: a pixel centre exactly on a
    vertex (uu 0 on one edge, 1 on the other, equal d2) and exactly on an
    edge."""
    rng = np.random.default_rng(0)
    a = chip_smoke.shade_tie_attrs(rng, T, 32, TILES_X, TILE)
    px = (np.arange(T)[:, None] % TILES_X) * TILE + np.arange(P)[None] % TILE + 0.5
    py = (np.arange(T)[:, None] // TILES_X) * TILE + np.arange(P)[None] // TILE + 0.5
    on_vertex = ((a[:, 0::8, 0][..., None] == px[:, None]) &
                 (a[:, 0::8, 1][..., None] == py[:, None])).any(-1)
    assert on_vertex[:, 0].all()                  # kind 0 rows: vertex a on a centre
    mid = (a[:, 8, 0] + a[:, 8, 2]) / 2           # kind 1 rows: centre mid-edge
    assert ((mid[:, None] == px) & (a[:, 8, 1][:, None] == py)).any(-1).all()
    axis = a[:, 16, 0]                            # kind 2 rows: symmetric about x
    assert ((a[:, 16, 2] + a[:, 16, 4]) / 2 == axis).all()
    assert ((axis[:, None] == px).any(-1)).all()


def test_composite_function_matches_autograd_of_forward_twin():
    """CompositeTiles.backward (the analytic kernel-2 twin) against autograd
    of the forward twin, abs 1e-5 + rel 1e-5, on random rows where no
    o·e^power sits exactly at the 0.99 clamp."""
    rng = np.random.default_rng(5)
    a = torch.as_tensor(chip_smoke.random_composite_attrs(rng, T, 32, TILES_X, TILE))
    g, ga = (torch.as_tensor(x) for x in chip_smoke.cotangents(rng, T, P))
    x1 = a.clone().requires_grad_(True)
    rgb, alpha = SK.CompositeTiles.apply(x1, TILES_X, TILE, TILE)
    (d1,) = torch.autograd.grad((rgb * g).sum() + (alpha * ga).sum(), x1)
    x2 = a.clone().requires_grad_(True)
    rgb2, alpha2 = SK.composite_tiles_ref(x2, TILES_X, TILE, TILE)
    (d2,) = torch.autograd.grad((rgb2 * g).sum() + (alpha2 * ga).sum(), x2)
    assert torch.equal(rgb, rgb2.detach()) and torch.equal(alpha, alpha2.detach())
    tol = 1e-5 + 1e-5 * float(d2.abs().max())
    torch.testing.assert_close(d1[..., :10], d2[..., :10], rtol=0, atol=tol)


def test_shade_function_matches_autograd_of_forward_twin():
    """ShadeTiles.backward (the analytic kernel-4 twin) against autograd of
    the forward twin through rgb and soft, abs 1e-5 + rel 1e-5, on random
    rows with no half-gradient ties (no built ties; slivers made invalid)."""
    rng = np.random.default_rng(6)
    a = chip_smoke.random_shade_attrs(rng, T, 32, TILES_X, TILE)
    a[..., 9] *= np.abs(_area(a)) > 1e-2
    a = torch.as_tensor(a)
    g, gs = (torch.as_tensor(x) for x in chip_smoke.cotangents(rng, T, P))
    x1 = a.clone().requires_grad_(True)
    rgb, hard, soft, fid = MK.ShadeTiles.apply(x1, TILES_X, TILE, TILE, 1.0)
    assert not hard.requires_grad and not fid.requires_grad
    (d1,) = torch.autograd.grad((rgb * g).sum() + (soft * gs).sum(), x1)
    x2 = a.clone().requires_grad_(True)
    rgb2, _, soft2, _ = MK.shade_tiles_ref(x2, TILES_X, TILE, TILE, 1.0)
    (d2,) = torch.autograd.grad((rgb2 * g).sum() + (soft2 * gs).sum(), x2)
    tol = 1e-5 + 1e-5 * float(d2[..., :19].abs().max())
    torch.testing.assert_close(d1[..., :19], d2[..., :19], rtol=0, atol=tol)
    assert float(d1[..., 10:19].abs().max()) > 0.1 and float(d1[..., :6].abs().max()) > 0.01


def test_bwd_wrappers_take_the_twin_on_cpu_without_counting():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(chip_smoke.random_composite_attrs(rng, T, 16, TILES_X, TILE))
    s = torch.as_tensor(chip_smoke.random_shade_attrs(rng, T, 16, TILES_X, TILE))
    g, g1 = (torch.as_tensor(x) for x in chip_smoke.cotangents(rng, T, P))
    n1, n2 = SK.composite_bwd.launches, MK.shade_bwd.launches
    assert torch.equal(SK.composite_bwd(a, g, g1, TILES_X, TILE, TILE),
                       SK.composite_bwd_ref(a, g, g1, TILES_X, TILE, TILE))
    assert torch.equal(MK.shade_bwd(s, g, g1, TILES_X, TILE, TILE, 1.0),
                       MK.shade_bwd_ref(s, g, g1, TILES_X, TILE, TILE, 1.0))
    assert (SK.composite_bwd.launches, MK.shade_bwd.launches) == (n1, n2)


@pytest.mark.parametrize("which", ["composite", "shade"])
def test_bwd_wrappers_check_their_inputs(which):
    lanes = 16 if which == "composite" else 24

    def fn(x, g, g1):
        if which == "composite":
            return SK.composite_bwd(x, g, g1, TILES_X, TILE, TILE)
        return MK.shade_bwd(x, g, g1, TILES_X, TILE, TILE, 1.0)

    g, g1 = torch.zeros((T, P, 3)), torch.zeros((T, P))
    with pytest.raises(ValueError):
        fn(torch.zeros((T, 8, lanes + 1)), g, g1)
    with pytest.raises(TypeError):
        fn(torch.zeros((T, 8, lanes), dtype=torch.float64), g, g1)
    with pytest.raises(ValueError):
        fn(torch.zeros((T, 8, lanes)), g[:, :-1], g1)
    with pytest.raises(TypeError):
        fn(torch.zeros((T, 8, lanes)), g, g1.double())
    if which == "composite":   # and the forward's residuals rgb and S
        x = torch.zeros((T, 8, lanes))
        rgb, S = torch.zeros((T, P, 3)), torch.zeros((T, P))
        for bad in ((rgb, None), (None, S), (rgb.double(), S), (rgb, S.double()),
                    (rgb[:, :-1], S), (rgb, S[:-1]), (rgb[..., :2], S)):
            with pytest.raises(ValueError):
                SK.composite_bwd(x, g, g1, TILES_X, TILE, TILE, *bad)
