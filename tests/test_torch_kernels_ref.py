"""The port's kernel twins against the JAX Pallas kernels (interpret mode).

``composite_tiles_ref`` and ``shade_tiles_ref`` are the plain PyTorch twins of
the port's CUDA kernels; on the CPU the wrappers run them.  The same seeded
rows, with the edge cases (invalid rows, alpha-clamped rows, slivers below
AREA_MIN, back faces, exact z ties), go through the JAX Pallas kernels in
interpret mode.  The CUDA kernels themselves are held against these twins on
the GPU by chip_smoke.py.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (seeded edge-case rows shared with the GPU check)
from dgmesh_torch.ops import mesh_raster_kernels as MK  # noqa: E402
from dgmesh_torch.ops import splat_kernels as SK  # noqa: E402
from dgmesh_tpu.ops.mesh_raster_pallas import shade_tiles_pallas  # noqa: E402
from dgmesh_tpu.ops.splat_pallas import composite_tiles_pallas  # noqa: E402

torch.set_num_threads(1)

TILES_X, TILE = 4, 16
T = 12                      # 4 x 3 tiles of 16 x 16


@pytest.mark.parametrize("seed,K", [(0, 64), (1, 48), (2, 96)])
def test_composite_twin_matches_pallas(seed, K):
    """Tolerance abs 1e-5: the Pallas kernel sums log(1-α) with a
    lower-triangular matmul, the twin with torch.cumsum (same log-space
    transmittance, different summation order)."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.random_composite_attrs(rng, T, K, TILES_X, TILE)
    want = composite_tiles_pallas(jnp.asarray(a), TILES_X, TILE, TILE, interpret=True)
    got = SK.composite_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert float(got[1].max()) > 0.5          # the rows do cover pixels


@pytest.mark.parametrize("case,K", chip_smoke.COMPOSITE_EDGE_SHAPES)
def test_composite_twin_matches_pallas_at_edge_shapes(case, K):
    """The twin against the Pallas kernel at the shapes chip_smoke.py also
    holds the CUDA kernel to (one row, a ragged K, a tile with no valid row,
    every row valid, valid rows interleaved with invalid ones, rows at the
    0.99 clamp, a pixel whose T falls to 0), over 2 tiles at the card's
    seeds: rgb and alpha within abs 1e-5 (sums in another order, as above);
    a tile with no valid row exactly 0; S finite and alpha = 1 - e^S."""
    rng = np.random.default_rng(K)
    nt = chip_smoke.COMPOSITE_EDGE_TILES
    a = chip_smoke.composite_edge_attrs(rng, case, K, nt, 2, TILE)
    want = composite_tiles_pallas(jnp.asarray(a), 2, TILE, TILE, interpret=True)
    rgb, alpha, S = SK.composite_tiles_ref(torch.as_tensor(a), 2, TILE, TILE, residuals=True)
    for g, w in zip((rgb, alpha), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert torch.isfinite(S).all() and torch.equal(alpha, 1.0 - torch.exp(S))
    valid = a[..., 9] > 0.5
    if case == "all invalid":
        assert not valid[0].any() and valid[1].any()
        assert not rgb[0].any() and not alpha[0].any() and not S[0].any()
    if case == "T to 0":
        assert float(alpha.max()) == 1.0                # T fell below float32's range
    else:
        assert float(alpha.max()) > 0.0                 # the rows do cover pixels


@pytest.mark.parametrize("seed,K,sigma", [(0, 32, 1.0), (1, 48, 0.7), (2, 64, 1.5)])
def test_shade_twin_matches_pallas(seed, K, sigma):
    """rgb and soft abs 1e-5 (sums over K in another order); hard coverage
    and the winner face id exact (same arithmetic, first maximum)."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.random_shade_attrs(rng, T, K, TILES_X, TILE)
    want = shade_tiles_pallas(jnp.asarray(a), TILES_X, TILE, TILE, sigma, interpret=True)
    got = MK.shade_tiles_ref(torch.as_tensor(a), TILES_X, TILE, TILE, sigma)
    rgb, hard, soft, fid = (g.numpy() for g in got)
    np.testing.assert_array_equal(hard, np.asarray(want[1]))
    np.testing.assert_array_equal(fid, np.asarray(want[3]))
    np.testing.assert_allclose(rgb, np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(soft, np.asarray(want[2]), rtol=0, atol=1e-5)
    assert 0.1 < hard.mean() < 1.0


def test_edge_case_rows_are_present():
    """The seeded rows hold every edge case the comparisons claim to cover."""
    rng = np.random.default_rng(0)
    c = chip_smoke.random_composite_attrs(rng, T, 64, TILES_X, TILE)
    assert (c[..., 9] == 0).any() and (c[..., 5] >= 0.99).any()
    s = chip_smoke.random_shade_attrs(rng, T, 64, TILES_X, TILE)
    area = ((s[..., 2] - s[..., 0]) * (s[..., 5] - s[..., 1])
            - (s[..., 3] - s[..., 1]) * (s[..., 4] - s[..., 0]))
    assert (np.abs(area) < 1e-4).any() and (area < 0).any() and (area > 0).any()
    same = (s[:, 1:, :19] == s[:, :-1, :19]).all(-1)
    assert same.any() and (s[:, 1:, 19] != s[:, :-1, 19])[same].any()


def test_wrappers_take_the_twin_on_cpu_without_counting():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(chip_smoke.random_composite_attrs(rng, T, 32, TILES_X, TILE))
    s = torch.as_tensor(chip_smoke.random_shade_attrs(rng, T, 32, TILES_X, TILE))
    n1, n2 = SK.composite_tiles.launches, MK.shade_tiles.launches
    for g, w in zip(SK.composite_tiles(a, TILES_X, TILE, TILE),
                    SK.composite_tiles_ref(a, TILES_X, TILE, TILE)):
        assert torch.equal(g, w)
    for g, w in zip(MK.shade_tiles(s, TILES_X, TILE, TILE, 1.0),
                    MK.shade_tiles_ref(s, TILES_X, TILE, TILE, 1.0)):
        assert torch.equal(g, w)
    assert (SK.composite_tiles.launches, MK.shade_tiles.launches) == (n1, n2)


@pytest.mark.parametrize("which", ["composite", "shade"])
def test_wrappers_check_their_inputs(which):
    fn = ((lambda x: SK.composite_tiles(x, TILES_X, TILE, TILE)) if which == "composite"
          else (lambda x: MK.shade_tiles(x, TILES_X, TILE, TILE, 1.0)))
    lanes = 16 if which == "composite" else 24
    with pytest.raises(ValueError):
        fn(torch.zeros((T, 8, lanes + 1)))
    with pytest.raises(TypeError):
        fn(torch.zeros((T, 8, lanes), dtype=torch.float64))
