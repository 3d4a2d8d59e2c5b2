"""The gate box of the splat compositor's forward kernel (``csrc/composite.cu``)
against the plain twin's gate, in float32 PyTorch on the CPU.

The kernel skips a row, for a whole warp, where the row's gate box misses
the warp's block of pixels.  The box must hold every pixel where the gate
can pass (power <= 0 and min(0.99, o e^power) >= 1/255, in float32): from
the conic [[a, b], [b, c]] with |b| <= (1 - 2^-10) sqrt(ac), the opacity
and the mean, |dx| <= sqrt(R2 c / det) and |dy| <= sqrt(R2 a / det) with
R2 = (ln(255 o) + 2^-20) / (1/2 - 2^-11), each half-width widened by 2^-20
of itself and 2^-20 of a pixel.  A row whose mean, conic or opacity is not
finite, whose conic is not so conditioned, or with o > 2^20 gets an
unbounded box; o <= 0, or o far enough below 1/255, an empty one.

``gate_box`` models the kernel's box in float64 rounded to nearest, where
the kernel rounds each step outward: the model's box is the kernel's or
lies inside it, so a pair outside the model's box is outside the kernel's.
On seeded rows (``chip_smoke``'s random composite rows, every
``COMPOSITE_EDGE_SHAPES`` case), on rows built so that o e^power sits on
1/255 at pixel centres, and on rows with o > 1, o = 0, NaN, infinite and
ill-conditioned conics, every (row, pixel) outside the box must fail both
the twin's gate (``composite_tiles_ref``) and the kernel's (its clamp
``raw > 0.99 ? 0.99 : raw`` keeps a NaN product, which fails, as in the
twin and in JAX).  torch.exp is
within an ulp here; the box's 2^-20 covers the 2 ulp of the card's expf.
The kernel itself is held against the twin, and against its parent's
bits, on the card (chip_smoke.py, tools/torch_shade_bwd_variants.py).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (seeded rows shared with the GPU check)
from dgmesh_torch.ops import splat_kernels as SK  # noqa: E402

torch.set_num_threads(1)

ALPHA_MIN = float(np.float32(1.0) / np.float32(255.0))   # the kernel's 1.0f / 255.0f
RHO2_MAX = (1.0 - 2.0 ** -10) ** 2
O_MAX = 2.0 ** 20
INF, NAN = float("inf"), float("nan")


def gate_box(rows):
    """(xlo, xhi, ylo, yhi) float64 arrays (of float32 values) of the rows
    (..., 16) float32: the kernel's gate box, or one inside it."""
    mx, my, ca, cb, cc, o = (rows[..., i].astype(np.float64) for i in range(6))
    lo = np.full(mx.shape, -INF)
    hi = np.full(mx.shape, INF)
    xlo, xhi, ylo, yhi = lo.copy(), hi.copy(), lo.copy(), hi.copy()
    finite = np.isfinite(rows[..., :6]).all(-1)
    none = finite & (o <= 0.0)
    with np.errstate(all="ignore"):
        ac, bb = ca * cc, cb * cb                      # exact: float32 products
        cand = (finite & (o > 0.0) & (o <= O_MAX) & (ca > 0.0) & (cc > 0.0)
                & (bb <= RHO2_MAX * ac))
        lead = np.log(o / ALPHA_MIN) + 2.0 ** -20
        none |= cand & (lead < 0.0)
        box = cand & (lead >= 0.0)
        r2 = lead / (0.5 - 2.0 ** -11)
        det = ac - bb
        ex = np.sqrt(r2 * (cc / det)) * (1.0 + 2.0 ** -20) + 2.0 ** -20
        ey = np.sqrt(r2 * (ca / det)) * (1.0 + 2.0 ** -20) + 2.0 ** -20
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    xlo[box], xhi[box] = f32(mx - ex)[box], f32(mx + ex)[box]
    ylo[box], yhi[box] = f32(my - ey)[box], f32(my + ey)[box]
    xlo[none], xhi[none], ylo[none], yhi[none] = INF, -INF, INF, -INF
    return xlo, xhi, ylo, yhi


def gates(a, px, py):
    """The twin's and the kernel's gate for every (tile, row, pixel): a
    (T,K,16) float32, px and py (T,P) float32 pixel centres."""
    dx = a[..., 0:1] - px[:, None, :]
    dy = a[..., 1:2] - py[:, None, :]
    power = -0.5 * (a[..., 2:3] * dx * dx + a[..., 4:5] * dy * dy) - a[..., 3:4] * dx * dy
    raw = a[..., 5:6] * torch.exp(power)
    twin = (power <= 0.0) & (torch.clamp_max(raw, SK.ALPHA_MAX) >= SK.ALPHA_MIN)
    kernel = (power <= 0.0) & (torch.where(raw > SK.ALPHA_MAX, SK.ALPHA_MAX, raw)
                               >= SK.ALPHA_MIN)
    return twin, kernel


def outside(a, px, py):
    """(tile, row, pixel) pairs whose pixel is outside the row's gate box."""
    xlo, xhi, ylo, yhi = (torch.as_tensor(v)[..., None] for v in gate_box(a.numpy()))
    x, y = px.double()[:, None, :], py.double()[:, None, :]
    return (x < xlo) | (x > xhi) | (y < ylo) | (y > yhi)


def check(a, px, py):
    """No pair outside the box passes either gate; returns the share of
    pairs outside it and the number of pairs that pass the twin's gate."""
    a = torch.as_tensor(a)
    out = outside(a, px, py)
    twin, kernel = gates(a, px, py)
    assert not (twin & out).any(), "a pair outside the box passes the twin's gate"
    assert not (kernel & out).any(), "a pair outside the box passes the kernel's gate"
    return float(out.double().mean()), int(twin.sum())


def tile_grid(T, tiles_x, tile):
    return SK.tile_pixels(T, tiles_x, tile, tile, 0.0, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_random_rows_outside_the_box_fail_the_gate(seed):
    """chip_smoke's random composite rows (o up to 1.5, a tenth clamped):
    most pairs lie outside the box, and none of them passes."""
    rng = np.random.default_rng(seed)
    a = chip_smoke.random_composite_attrs(rng, 8, 64, 4, 16)
    share, n_pass = check(a, *tile_grid(8, 4, 16))
    assert share > 0.3 and n_pass > 1000


@pytest.mark.parametrize("case,K", chip_smoke.COMPOSITE_EDGE_SHAPES)
def test_edge_shapes_outside_the_box_fail_the_gate(case, K):
    rng = np.random.default_rng(K)
    nt = chip_smoke.COMPOSITE_EDGE_TILES
    a = chip_smoke.composite_edge_attrs(rng, case, K, nt, 2, 16)
    check(a, *tile_grid(nt, 2, 16))


def threshold_rows(rng, n, rho_max, scale, origin):
    """Rows whose o e^power is 1/255, to a few float32 ulps either side, at
    a pixel centre near the mean: a random conic (the major axis' 1 /
    eigenvalue scale^2 to scale^2 / 3, up to 50 times as narrow across, any
    rotation, |b| / sqrt(ac) up to rho_max), a mean at a random sub-pixel
    offset from ``origin``, a target pixel where the conic's quadratic
    form is 0.1 to 11 (for half the rows the pixel where that ellipse
    reaches furthest in x or in y, on its bounding box's edge), and o set
    from the float32 power there, then moved by -3..3 ulps.  Rows whose o
    falls outside [1/255, 2] are dropped."""
    a = np.zeros((n, 16), np.float32)
    th = rng.uniform(0, np.pi, n)
    l2 = rng.uniform(1.0, 3.0, n) / scale ** 2
    l1 = l2 * rng.uniform(1.0, 50.0, n)
    c, s = np.cos(th), np.sin(th)
    ca, cb, cc = l1 * c * c + l2 * s * s, (l1 - l2) * c * s, l1 * s * s + l2 * c * c
    rho = np.abs(cb) / np.sqrt(ca * cc)
    cb = np.where(rho > rho_max, np.sign(cb) * rho_max * np.sqrt(ca * cc), cb)
    a[:, 0] = origin[0] + rng.uniform(0, 16, n)
    a[:, 1] = origin[1] + rng.uniform(0, 16, n)
    a[:, 2], a[:, 3], a[:, 4] = ca, cb, cc
    d = a[:, 2:5].astype(np.float64)
    u = rng.normal(size=(n, 2))
    q_u = d[:, 0] * u[:, 0] ** 2 + 2 * d[:, 1] * u[:, 0] * u[:, 1] + d[:, 2] * u[:, 1] ** 2
    t = np.sqrt(rng.uniform(0.1, 11.0, n) / q_u)
    tx = np.round(a[:, 0] + t * u[:, 0]).astype(np.float32)
    ty = np.round(a[:, 1] + t * u[:, 1]).astype(np.float32)
    # half the rows: the target pixel where the ellipse through it reaches
    # furthest in x (offset along (c, -b)) or in y (along (-b, a)), so that
    # it lies on the edge of the ellipse's bounding box
    q = rng.uniform(0.1, 11.0, n)
    det = d[:, 0] * d[:, 2] - d[:, 1] ** 2
    along_x = rng.random(n) < 0.5
    v = np.where(along_x[:, None], np.stack([d[:, 2], -d[:, 1]], 1),
                 np.stack([-d[:, 1], d[:, 0]], 1))
    tv = np.sqrt(q / (np.where(along_x, d[:, 2], d[:, 0]) * det))
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    edge = rng.random(n) < 0.5
    a[edge, 0] = (tx + sign * tv * v[:, 0])[edge]
    a[edge, 1] = (ty + sign * tv * v[:, 1])[edge]
    f = np.float32
    dx, dy = a[:, 0] - tx, a[:, 1] - ty
    power = f(-0.5) * (a[:, 2] * dx * dx + a[:, 4] * dy * dy) - a[:, 3] * dx * dy
    with np.errstate(over="ignore"):
        o = f(ALPHA_MIN) / np.exp(power)
    for _ in range(3):
        o = np.where(rng.random(n) < 0.5, np.nextafter(o, f(0)), np.nextafter(o, f(1e30)))
    a[:, 5] = o
    a[:, 6:9] = 0.5
    a[:, 9] = 1.0
    keep = (o >= f(ALPHA_MIN)) & (o <= 2.0)
    return a[keep], tx[keep], ty[keep]


@pytest.mark.parametrize("rho_max,scale,origin", [
    (0.9, 3.0, (0, 0)), (1.0 - 2.0 ** -10, 2.0, (0, 0)), (0.999999, 4.0, (0, 0)),
    (0.5, 8.0, (0, 0)), (0.9, 3.0, (1000, 2000)), (1.0 - 2.0 ** -10, 2.0, (700, 300))])
def test_rows_at_the_threshold_outside_the_box_fail_the_gate(rho_max, scale, origin):
    """Rows built to sit on the gate's threshold at a pixel centre, near
    the image origin (where float32 resolves the box's margins) and far
    from it, held on a 48x48 window of pixels around each mean: no pixel
    outside the box
    passes, the target pixels pass on both sides of the threshold, and
    where the conic is within the box's conditioning the box is at most
    2^-9 wider than the ellipse's."""
    rng = np.random.default_rng(int(scale * 10) + int(rho_max * 1000))
    a, tx, ty = threshold_rows(rng, 600, rho_max, scale, origin)
    assert len(a) > 300
    ox = np.floor(a[:, 0]) - 24
    oy = np.floor(a[:, 1]) - 24
    g = np.arange(48)
    px = torch.as_tensor((ox[:, None] + np.tile(g, 48)[None]).astype(np.float32))
    py = torch.as_tensor((oy[:, None] + np.repeat(g, 48)[None]).astype(np.float32))
    share, n_pass = check(a[:, None, :], px, py)
    assert 0.05 < share < 0.999 and n_pass > 0
    # the target pixels: o moved either side of the threshold, so some pass
    t = torch.as_tensor(a[:, None, :])
    twin, _ = gates(t, torch.as_tensor(tx)[:, None], torch.as_tensor(ty)[:, None])
    assert 0 < int(twin.sum()) < len(a)
    xlo, xhi, _, _ = gate_box(a)
    d = a.astype(np.float64)
    det = d[:, 2] * d[:, 4] - d[:, 3] ** 2
    ideal = np.sqrt(2.0 * np.log(d[:, 5] / ALPHA_MIN) * d[:, 4] / det)
    bounded = np.isfinite(xhi)
    assert bounded.sum() >= (len(a) if rho_max <= 1.0 - 2.0 ** -10 else 1)
    assert (((xhi - xlo) / 2)[bounded] <= ideal[bounded] * (1 + 2.0 ** -9) + 1e-3).all()


def special_rows():
    """Rows with values the box must treat with care, each on a 16x16 tile
    around its mean: opacity 0, -0, negative, tiny, exactly 1/255 and the
    float32 either side, 1.5, 2^20 and above, inf and NaN; conics with a
    zero, negative, inf or NaN entry, |b| = sqrt(ac) and just inside
    (1 - 2^-10); means with inf or NaN, or far off."""
    amin = np.float32(ALPHA_MIN)
    base = [8.3, 7.6, 0.05, 0.01, 0.07, 0.8]
    rows = []
    for o in (0.0, -0.0, -1.0, 1e-12, amin, np.nextafter(amin, np.float32(0)),
              np.nextafter(amin, np.float32(1)), 0.99, 1.5, 2.0 ** 20,
              np.nextafter(np.float32(2.0 ** 20), np.float32(INF)), 1e30, INF, NAN):
        rows.append(base[:5] + [o])
    for conic in ((0.0, 0.0, 0.07), (-0.05, 0.0, 0.07), (0.05, 0.0, -0.07), (INF, 0.0, 0.07),
                  (0.05, INF, 0.07), (0.05, NAN, 0.07), (NAN, 0.0, 0.07),
                  (0.05, float(np.sqrt(np.float32(0.05) * np.float32(0.07))), 0.07),
                  (0.05, (1 - 2.0 ** -10) * 0.99999 * float(np.sqrt(0.05 * 0.07)), 0.07),
                  (1e-30, 0.0, 1e-30), (1e3, 0.0, 1e3)):
        rows.append(base[:2] + list(conic) + [0.9])
    for mean in ((INF, 7.6), (8.3, NAN), (-INF, INF), (3e30, 7.6)):
        rows.append(list(mean) + base[2:])
    a = np.zeros((len(rows), 16), np.float32)
    a[:, :6] = np.array(rows, np.float64).astype(np.float32)
    a[:, 6:9] = 0.5
    a[:, 9] = 1.0
    return a


def test_special_rows_outside_the_box_fail_the_gate():
    a = special_rows()
    g = np.arange(16, dtype=np.float32)
    px = torch.as_tensor(np.tile(g, 16))[None].expand(len(a), -1)
    py = torch.as_tensor(np.repeat(g, 16))[None].expand(len(a), -1)
    check(a[:, None, :], px, py)
    xlo, xhi, _, _ = gate_box(a)
    o, finite = a[:, 5], np.isfinite(a[:, :6]).all(-1)
    empty = xlo > xhi
    assert (empty == (finite & (o <= 0) | (finite & (o > 0) & (o < 0.99 * ALPHA_MIN)))).all()
    unbounded = np.isinf(xlo) & np.isinf(xhi) & (xlo < xhi)
    assert unbounded[~finite].all() and unbounded[finite & (o > 2.0 ** 20)].all()
    # a NaN opacity fails both gates at every pixel; the box leaves every
    # such pair to the gate
    nan_o = np.isnan(o)
    twin, kernel = gates(torch.as_tensor(a[nan_o][:, None, :]), px[:1], py[:1])
    assert nan_o.any() and not twin.any() and not kernel.any()
