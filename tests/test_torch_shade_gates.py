"""The shortcuts of the mesh shade forward kernel (``csrc/shade.cu``)
against the plain twin's operations, in float32 PyTorch on the CPU.

The kernel skips the barycentric division where the gate decides the pair
anyway, and takes per-row constants from shared memory:
- barycentrics: no ``e_i / as`` where some edge function has the sign
  opposite to the area and ``|e_i| >= 2^-22`` (the quotient is then surely
  negative: ``|as| < 2^128`` keeps it above 2^-150, so it never rounds to -0,
  which would pass ``b >= 0``);
- ``-sd / sigma`` is ``-sd * (1 / sigma)`` where sigma is a power of two;
- the edge functions and the edge projections use the row's edge vectors
  and squared lengths, computed once.
``kernel_walk`` models the kernel's operations, ``twin_walk`` the twin's
(``shade_tiles_ref``); on seeded rows (``chip_smoke``'s random rows, rows
with built ties, every ``SHADE_EDGE_SHAPES`` case), on built rows and on
built values they must give the same gate, the same barycentrics and the
same squared edge distances, bit for bit.  The kernel itself is held
against the twin on the card by chip_smoke.py.  The kernel's clamps and
nearest-edge minimum keep a NaN, as the twin's do (``keep_nan.cuh``; with
``fminf``/``fmaxf`` a row with a NaN corner gave a finite d2min, F5).
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (seeded rows shared with the GPU check)
from dgmesh_torch.ops import mesh_raster_kernels as MK  # noqa: E402
from dgmesh_torch.ops.splat_kernels import tile_pixels  # noqa: E402

torch.set_num_threads(1)

TILES_X, TILE = 2, 16
T = 4
FLT_MAX = torch.finfo(torch.float32).max
SURE_NEG = 2.0 ** -22
INF = float("inf")


def f32(*v):
    return torch.tensor(v, dtype=torch.float32)


def bits(x):
    return x.contiguous().view(torch.int32)


# keep_nan.cuh: fmaxf/fminf where no operand is NaN, the NaN otherwise
def keep_nan_max(v, lo):
    return torch.where(v.isnan(), v, torch.fmax(v, torch.full_like(v, lo)))


def keep_nan_clamp(v, lo, hi):
    return torch.where(v.isnan(), v, torch.fmin(torch.fmax(v, torch.full_like(v, lo)),
                                                torch.full_like(v, hi)))


def keep_nan_min(a, b):
    return torch.where((b < a) | b.isnan(), b, a)


def sure_negative(e, sg, lim):
    """The kernel's test: e / as is surely negative (sg the sign of as, lim
    -2^-22 where as is finite, else -inf)."""
    return e * sg <= lim


def twin_walk(a, px, py):
    """inside, the barycentrics and d2min of every (tile, row, pixel) by the
    twin's operations (shade_tiles_ref)."""
    ax, ay, bx, by, cx, cy = (a[..., i:i + 1] for i in range(6))
    valid = a[..., 9:10] > 0.5
    e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    live = area.abs() >= MK.AREA_MIN
    area = torch.where(live, area, 1.0)
    b = (e0 / area, e1 / area, e2 / area)
    inside = (b[0] >= 0.0) & (b[1] >= 0.0) & (b[2] >= 0.0) & valid & live
    d2min = None
    for vx0, vy0, vx1, vy1 in ((ax, ay, bx, by), (bx, by, cx, cy), (cx, cy, ax, ay)):
        ex, ey = vx1 - vx0, vy1 - vy0
        qx, qy = px - vx0, py - vy0
        t = torch.clamp((qx * ex + qy * ey) / torch.clamp_min(ex * ex + ey * ey, 1e-12),
                        0.0, 1.0)
        dx, dy = qx - t * ex, qy - t * ey
        d2 = dx * dx + dy * dy
        d2min = d2 if d2min is None else torch.minimum(d2min, d2)
    return inside, b, d2min


def kernel_walk(a, px, py):
    """The same by the kernel's operations: per-row constants and the sign
    test before the barycentric division.  Also returns how many valid
    pairs took the shortcut and how many the division."""
    ax, ay, bx, by, cx, cy = (a[..., i:i + 1] for i in range(6))
    valid = a[..., 9:10] > 0.5
    # staging: once per row
    ex = (bx - ax, cx - bx, ax - cx)
    ey = (by - ay, cy - by, ay - cy)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    live = area.abs() >= MK.AREA_MIN
    as_ = torch.where(live, area, 0.0)
    h = [keep_nan_max(x * x + y * y, 1e-12) for x, y in zip(ex, ey)]
    sg = torch.where(area > 0, 1.0, -1.0)
    # a row with a corner at or beyond 2^60 (or NaN) is not safe: no shortcut
    safe = (a[..., 0:6].abs() < 2.0 ** 60).all(-1, keepdim=True)
    lim = torch.where(safe, -SURE_NEG, -INF)
    # each pixel: q from each corner, the edge functions from the edge vectors
    qx, qy = (px - ax, px - bx, px - cx), (py - ay, py - by, py - cy)
    e = (ex[1] * qy[1] - ey[1] * qx[1],
         ex[2] * qy[2] - ey[2] * qx[2],
         ex[0] * qy[0] - ey[0] * qx[0])
    skip = (sure_negative(e[0], sg, lim) | sure_negative(e[1], sg, lim)
            | sure_negative(e[2], sg, lim))
    divide = valid & live & ~skip
    b = tuple(torch.where(divide, ei / torch.where(live, as_, 1.0), 0.0) for ei in e)
    inside = divide & (b[0] >= 0.0) & (b[1] >= 0.0) & (b[2] >= 0.0)
    d2min = None     # keep_nan's clamps and minimum: fminf/fmaxf's bits on a safe row
    for k in range(3):
        t = keep_nan_clamp((qx[k] * ex[k] + qy[k] * ey[k]) / h[k], 0.0, 1.0)
        dx, dy = qx[k] - t * ex[k], qy[k] - t * ey[k]
        d2 = dx * dx + dy * dy
        d2min = d2 if d2min is None else keep_nan_min(d2min, d2)
    taken = {"skip": int((valid & live & skip).sum()), "divide": int(divide.sum())}
    return inside, b, d2min, taken


def rows(case, K):
    rng = np.random.default_rng(K)
    if case == "random":
        return chip_smoke.random_shade_attrs(rng, T, K, TILES_X, TILE), T
    if case == "ties":
        return chip_smoke.shade_tie_attrs(rng, T, K, TILES_X, TILE), T
    nt = chip_smoke.SHADE_EDGE_TILES
    return chip_smoke.shade_edge_attrs(rng, case, K, nt, TILES_X, TILE), nt


def built_rows():
    """One tile, rows built so that at some pixel centres an edge function
    is +0 or -0 (the centre on an edge, both windings), the edge
    projection's clip is exact at 0 and 1 (the centre square to a corner),
    an edge function is tiny beside a large area (a corner a float32 ulp
    off a pixel centre), the area is 0, and every pixel is inside."""
    a = np.zeros((1, 6, 24), np.float32)
    tris = [(0.5, 0.5, 8.5, 0.5, 0.5, 8.5),        # e = +0 along y = 0.5 and x = 0.5
            (0.5, 0.5, 0.5, 8.5, 8.5, 0.5),        # the other winding: e = -0
            (2.5, 2.5, 10.5, 2.5, 2.5, 4.5),       # t exactly 0 and 1 above a and b
            (np.float32(3.5) + np.float32(2 ** -22), 3.5, 3.5, 900.5, 1000.5, -800.5),
            (5.5, 5.5, 5.5, 5.5, 5.5, 5.5),        # a point: area 0, h at its clamp
            (-1e3, -1e3, 1e3, -1e3, 0.5, 1e3)]     # large area, every pixel inside
    for k, tri in enumerate(tris):
        a[0, k, 0:6] = tri
        a[0, k, 6:9] = (1.0, 0.5, 2.0)
        a[0, k, 9] = 1.0
    return a


CASES = ([("random", 32), ("ties", 40)]
         + [(c, K) for c, K in chip_smoke.SHADE_EDGE_SHAPES] + [("built", 6)])


@pytest.mark.parametrize("case,K", CASES)
def test_shortcuts_give_the_twins_gate_and_distances(case, K):
    """Bit for bit: inside, the barycentrics where inside, and d2min; and
    the winner and coverage that follow are shade_tiles_ref's."""
    a, nt = (built_rows(), 1) if case == "built" else rows(case, K)
    a = torch.as_tensor(a)
    px, py = tile_pixels(nt, TILES_X, TILE, TILE, 0.5, "cpu")
    px, py = px[:, None, :], py[:, None, :]
    inside_t, b_t, d2_t = twin_walk(a, px, py)
    inside_k, b_k, d2_k, taken = kernel_walk(a, px, py)
    assert torch.equal(inside_k, inside_t)
    for x, y in zip(b_k, b_t):
        assert torch.equal(bits(x[inside_t]), bits(y[inside_t]))
    valid = (a[..., 9:10] > 0.5).expand_as(d2_t)
    nan = d2_t.isnan()
    assert torch.equal(d2_k.isnan(), nan)             # a NaN row keeps its NaN
    assert torch.equal(bits(d2_k[valid & ~nan]), bits(d2_t[valid & ~nan]))
    if case in chip_smoke.SHADE_NAN_CASES[::2]:       # a NaN corner or edge length
        assert bool(nan[0].any()) and not bool(nan[1].any())
    # a safe row (every corner within 2^60) never meets a NaN there, so the
    # kernel's fminf/fmaxf path for it gives keep_nan's bits
    safe = (a[..., 0:6].abs() < 2.0 ** 60).all(-1, keepdim=True).expand_as(d2_t)
    assert not bool(nan[safe].any())
    # the winner (first maximum 1/w in K order) and coverage of the twin
    zi = b_k[0] * a[..., 6:7] + b_k[1] * a[..., 7:8] + b_k[2] * a[..., 8:9]
    zkey = torch.where(inside_k, zi, MK.NEG)
    win = torch.where(inside_k.any(1), torch.argmax(zkey, dim=1), -1)
    _, hard, _, _, win_ref, _ = MK.shade_tiles_ref(a, TILES_X, TILE, TILE, 1.0, residuals=True)
    assert torch.equal(inside_k.any(1).float(), hard)
    assert torch.equal(win.int(), win_ref)
    if case in ("random", "ties", "built"):   # rows on which both paths are taken
        assert all(v > 0 for v in taken.values()), taken
        assert bool(inside_t.any())


def test_barycentric_sign_test_on_built_values():
    """Where the kernel skips the division, e / as fails b >= 0: it is
    negative and not -0, or NaN (an infinite e over an infinite area);
    the values around the 2^-22 bound, zeros of both signs, a denormal e,
    NaN and infinities, with areas from AREA_MIN to beyond FLT_MAX."""
    tiny = float(np.nextafter(np.float32(SURE_NEG), np.float32(0)))
    ev = [0.0, -0.0, 1e-45, -1e-45, 1e-30, -1e-30, SURE_NEG, -SURE_NEG, tiny, -tiny,
          1.0, -1.0, 3e38, -3e38, INF, -INF, float("nan")]
    av = [1e-4, -1e-4, 1.0, -1.0, 1e6, -1e6, 3.4e38, -3.4e38, INF, -INF]
    e = f32(*ev)[:, None].expand(-1, len(av))
    area = f32(*av)[None, :].expand(len(ev), -1)
    sg = torch.where(area > 0, 1.0, -1.0)
    lim = torch.where(area.abs() <= FLT_MAX, -SURE_NEG, -INF)
    q = e / area
    skip = sure_negative(e, sg, lim)
    assert bool(skip.any()) and bool((~skip).any())
    assert not bool((q[skip] >= 0).any())          # b >= 0 fails: q < 0 (never -0) or NaN
    assert bool((q[skip & ~torch.isnan(q)] < 0).all())
    # where the true quotient underflows to -0 the kernel divides
    underflow = (q == 0) & torch.signbit(q)
    assert bool(underflow.any()) and not bool((underflow & skip).any())


@pytest.mark.parametrize("sigma", [0.25, 0.5, 1.0, 2.0, 8.0])
def test_power_of_two_sigma_multiplies_to_the_same_bits(sigma):
    """-sd / sigma and -sd * (1 / sigma) are one real number rounded once
    where 1/sigma is a power of two: the same float32, denormal and
    infinite results included."""
    rng = np.random.default_rng(int(sigma * 8))
    sd = np.concatenate([rng.normal(0, 30, 4096), rng.normal(0, 1e-38, 256),
                         [0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38, INF, -INF]])
    sd = torch.as_tensor(sd.astype(np.float32))
    m, ex = math.frexp(sigma)
    assert m == 0.5
    inv = torch.tensor(1.0 / sigma, dtype=torch.float32)
    assert torch.equal(bits(-sd / torch.tensor(sigma, dtype=torch.float32)), bits(-sd * inv))
