"""The port's bf16 and fused MLP trunks against the JAX package's.

The twins of kernels 5 and 6 (dgmesh_torch/ops/mlp_fused.py) against
``dgmesh_tpu.ops.mlp_pallas.fused_trunk`` in interpret mode, forward and
``jax.vjp``; the port's ``MLPTrunk`` in its three modes against flax's at
(dtype None, fuse False), (bf16, False) and (bf16, True) from the same
weights; a blender ``DeformNetwork`` in fused mode; and the precision
policy of the render path.

How the bf16 trunks may differ, and how the tests hold them.  Both sides
sum exact products of bf16 operands in float32, in other orders, then round
every activation to bf16.  Now and then the two float32 sums round to
neighbouring bf16 values; the change runs down the later layers of that row
and may move a pre-activation across 0, where the ReLU mask flips and the
row's gradient changes by the whole of that unit's term.  So each test
first finds the rows whose activations agree bit for bit in every layer on
both sides ("clean" rows; at least 3/4 of them must be), and holds those
tightly: the output exactly, and the gradients of a cotangent that is zero
on the other rows to float32 and bf16-gradient rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmesh_torch.config import Config
from dgmesh_torch.models import mlp as TM
from dgmesh_torch.ops import mlp_fused as MF
from dgmesh_torch.train.step import StepContext

from dgmesh_tpu.models import mlp as JM
from dgmesh_tpu.ops.mlp_pallas import fused_trunk

torch.set_num_threads(1)

DEPTH, SKIP = 8, 4


def _weights(rng, din):
    """flax-initialised trunk weights (lecun-normal (in,out) kernels) with
    N(0, 0.05) biases, so that the bias add is exercised."""
    ws, bs = [], []
    for i in range(DEPTH):
        d_in = din if i == 0 else 256
        if i == SKIP + 1:
            d_in += din
        ws.append((rng.normal(size=(d_in, 256)) / np.sqrt(d_in)).astype(np.float32))
        bs.append(rng.normal(0, 0.05, 256).astype(np.float32))
    return ws, bs


def _port_trunk(ws, bs):
    trunk = TM.MLPTrunk(ws[0].shape[0])
    with torch.no_grad():
        for layer, w, b in zip(trunk.layers, ws, bs):
            layer.weight.copy_(torch.tensor(w.T))
            layer.bias.copy_(torch.tensor(b))
    return trunk


def _pack(ws, bs):
    din = ws[0].shape[0]
    wpack, bpack = MF.pack_trunk(_port_trunk(ws, bs), din)
    return wpack.detach().numpy(), bpack.detach().numpy()


def _jax_fused_acts(xp, wpack, bpack):
    """JAX's bf16 activation of every layer, from fused_trunk cut to depth k
    (its x-part weight moved to index k)."""
    acts = []
    for k in range(1, DEPTH + 1):
        w = np.concatenate([wpack[:k], wpack[DEPTH:]])
        acts.append(np.asarray(fused_trunk(jnp.asarray(xp), jnp.asarray(w),
                                           jnp.asarray(bpack[:k]), k, SKIP)))
    return acts


def _jax_dense_acts(x, ws, bs):
    """flax's bf16 dense trunk (dgmesh_tpu/models/mlp.py:87-104), layer by
    layer, as the same jnp ops."""
    acts, h = [], jnp.asarray(x)
    inp = jnp.asarray(x)
    for i in range(DEPTH):
        x_in = h if i != SKIP + 1 else jnp.concatenate([inp.astype(h.dtype), h], axis=-1)
        y = jnp.matmul(x_in.astype(jnp.bfloat16), jnp.asarray(ws[i]).astype(jnp.bfloat16),
                       precision=jax.lax.Precision.HIGHEST) + jnp.asarray(bs[i]).astype(jnp.bfloat16)
        h = jax.nn.relu(y)
        acts.append(np.asarray(h.astype(jnp.float32)))
    return acts


def _port_acts(x, ws, bs, mode):
    """The port's bf16 activation of every layer in ``mode``."""
    if mode == "fused":
        wpack, bpack = _pack(ws, bs)
        _, acts = MF._forward_acts(torch.tensor(x), torch.tensor(wpack).to(torch.bfloat16),
                                   torch.tensor(bpack))
        return [a.float().numpy() for a in acts]
    trunk = _port_trunk(ws, bs)
    acts, inp = [], torch.tensor(x).to(torch.bfloat16)
    h = inp
    for i, layer in enumerate(trunk.layers):
        x_in = torch.cat([inp, h], -1) if i == SKIP + 1 else h
        h = torch.relu(TM.dense_bf16(layer, x_in))
        acts.append(h.float().detach().numpy())
    return acts


def _clean_rows(got, want):
    """Rows whose activations agree bit for bit in every layer."""
    clean = np.ones(got[0].shape[0], bool)
    for a, b in zip(got, want):
        clean &= (a == b).all(1)
    assert clean.mean() >= 0.75, f"only {clean.sum()} of {clean.size} rows agree bit for bit"
    return clean


# --- the twins of kernels 5 and 6 against fused_trunk ---------------------------

# (1, 93), (65, 93), (129, 1) and (129, 256) are shapes that kernel 6's
# tiling makes special (chip_smoke.py's MLP_EDGE_SHAPES): one row, a ragged
# second row block, the narrowest and the widest input; din 64, 65 and 192
# lie either side of the 64-lane blocks of x that kernel 5 multiplies
@pytest.mark.parametrize("n,din", [(64, 93), (37, 93), (64, 84), (37, 84),
                                   (1, 93), (65, 93), (129, 1), (129, 256),
                                   (129, 64), (129, 65), (129, 192)])
def test_twins_match_jax_fused_trunk(n, din):
    """Forward and vjp (dx, dwpack, dbpack) of fused_trunk (interpret mode)
    against trunk_fwd_ref/trunk_bwd_ref, on the clean rows: the output
    exactly; dx, dW and db to 5e-3 of each one's largest value + 1e-6, and
    a norm ratio of 1e-3.  The backward's float32 sums run in other orders,
    so its gmb = bf16(gm) may also round to the neighbouring bf16 value (one
    bf16 ulp, 2^-8 relative, on one term of a 256-term sum), and that runs
    down the row's lower layers as in the forward; measured ≤ 7.9e-4 of
    the max and ≤ 1.6e-4 in norm (2e-7 where no gmb flips).  The rows that
    are not clean get a zero cotangent on both sides; the output is held
    on every row to 1/32 of its largest value (a bf16 flip moves the layers
    below it by a few bf16 ulps)."""
    rng = np.random.default_rng(din * 100 + n)
    ws, bs = _weights(rng, din)
    wpack, bpack = _pack(ws, bs)
    x = rng.uniform(-1, 1, (n, din)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 256 - din)))
    clean = _clean_rows(_port_acts(x, ws, bs, "fused"), _jax_fused_acts(xp, wpack, bpack))
    g = rng.normal(size=(n, 256)).astype(np.float32) * clean[:, None]

    out, vjp = jax.vjp(lambda a, w, b: fused_trunk(a, w, b), jnp.asarray(xp),
                       jnp.asarray(wpack), jnp.asarray(bpack))
    dx, dw, db = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    out = np.asarray(out)
    wb, bp = torch.tensor(wpack).to(torch.bfloat16), torch.tensor(bpack)
    tout = MF.trunk_fwd_ref(torch.tensor(x), wb, bp).numpy()
    tdx, tdw, tdb = (v.numpy() for v in MF.trunk_bwd_ref(torch.tensor(x), wb, bp, torch.tensor(g)))

    np.testing.assert_array_equal(tout[clean], out[clean])
    np.testing.assert_allclose(tout, out, rtol=0, atol=np.abs(out).max() / 32)
    assert tdx.shape == (n, din) and tdw.shape == (9, 256, 256) and tdb.shape == (8, 256)
    for got, want in ((tdx, dx[:, :din]), (tdw, dw), (tdb, db)):
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3 * np.abs(want).max() + 1e-6)
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    assert not dw[0, din:].any() and not tdw[0, din:].any() and not tdw[DEPTH, din:].any()
    assert np.abs(tdw[DEPTH]).max() > 0 and np.abs(tdb).max() > 0


@pytest.mark.parametrize("din", [93, 65])
def test_x_weight_gradients_are_zero_past_din(din):
    """dW[0] and dW[8], whose left operand is x, are exactly 0 from row din
    on, in JAX's _bwd_kernel (interpret mode) and in the twin: x's padded
    lanes are zeros and gmb is finite.  Kernel 6's weight-gradient pass
    writes zeros to the rows past 64·ceil(din/64) and multiplies no tile
    past din (the MLPs' din 93: rows 128..255), which is exact only because
    of this."""
    from dgmesh_tpu.ops.mlp_pallas import _trunk_bwd
    rng = np.random.default_rng(din)
    ws, bs = _weights(rng, din)
    wpack, bpack = _pack(ws, bs)
    x = rng.uniform(-1, 1, (16, din)).astype(np.float32)
    g = rng.normal(size=(16, 256)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (0, 256 - din)))
    _, dw, _ = _trunk_bwd(DEPTH, SKIP, (jnp.asarray(xp), jnp.asarray(wpack), jnp.asarray(bpack)),
                          jnp.asarray(g))
    _, tdw, _ = MF.trunk_bwd_ref(torch.tensor(x), torch.tensor(wpack).to(torch.bfloat16),
                                 torch.tensor(bpack), torch.tensor(g))
    for got in (np.asarray(dw), tdw.numpy()):
        for e in (0, DEPTH):
            assert np.abs(got[e, :din]).max() > 0
            assert not got[e, din:].any(), (e, np.abs(got[e, din:]).max())


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("din", [1, 64, 65, 93, 128, 129, 256])
def test_wgrad_plan_covers_every_product_once(din, sms):
    """Kernel 6's weight-gradient plan at every trunk shape chip_smoke.py
    holds and on 132 and 114 SMs: the wrapper's row splits
    (mlp_fused.wgrad_splits) fill one wave beside the jobs, and the
    kernel's rule (csrc/mlp_bwd.cu's mlp_bwd_wgrad, written out here: CTA b
    runs job j = b % jobs, tile q % 2 of matrix q // 2 with q = j past
    dW[0]'s lone tile + 1, over split s = b // jobs's stages s·stages //
    splits ..) covers each (matrix e, 128-row dW tile, 64-row workspace
    stage) with exactly one CTA, except the tiles of dW[0] and dW[8] wholly
    past din, covered by none (the reduction writes zeros from row
    64·ceil(din/64) on); the two tiles of one matrix and split are next to
    each other in launch order."""
    import chip_smoke as cs
    x_tiles = 1 if din <= 128 else 2
    jobs = 2 * (DEPTH - 1) + 2 * x_tiles
    splits = MF.wgrad_splits(din, sms)
    assert splits * jobs <= sms < (splits + 1) * jobs
    for n in sorted({n for n, *_ in cs.MLP_EDGE_SHAPES} | set(cs.MLP_ROWS)):
        stages = -(-n // MF.BWD_ROWS) * MF.BWD_ROWS // 64
        covered = {}
        for b in range(splits * jobs):
            j, s = b % jobs, b // jobs
            q = 0 if j == 0 else j + 2 - x_tiles
            e, tile = q // 2, q % 2
            if tile == 1:
                qp = 0 if j - 1 == 0 else j + 1 - x_tiles
                assert (qp // 2, qp % 2) == (e, 0)
            covered.setdefault((e, tile), []).append(
                (s * stages // splits, (s + 1) * stages // splits))
        want = {(e, tile) for e in range(DEPTH + 1) for tile in range(2)
                if e not in (0, DEPTH) or tile < x_tiles}
        assert set(covered) == want, n
        for spans in covered.values():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == stages, n
            assert all(a[1] == b[0] and a[0] <= a[1] for a, b in zip(spans, spans[1:])), n


def test_twin_of_a_padded_input_is_the_unpadded_one():
    """x zero-padded to 256 lanes gives the same output, dW and db as x
    itself (the kernel reads (N, din) directly), and dx padded with the
    gradient of the zero lanes."""
    rng = np.random.default_rng(3)
    ws, bs = _weights(rng, 93)
    wpack, bpack = _pack(ws, bs)
    wb, bp = torch.tensor(wpack).to(torch.bfloat16), torch.tensor(bpack)
    x = torch.tensor(rng.uniform(-1, 1, (40, 93)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 256 - 93))
    g = torch.tensor(rng.normal(size=(40, 256)).astype(np.float32))
    assert torch.equal(MF.trunk_fwd_ref(x, wb, bp), MF.trunk_fwd_ref(xp, wb, bp))
    a, b = MF.trunk_bwd_ref(x, wb, bp, g), MF.trunk_bwd_ref(xp, wb, bp, g)
    assert torch.equal(a[0], b[0][:, :93]) and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twins_summation_order_spread(seed, monkeypatch):
    """How far the order of the float32 sums alone moves kernels 5 and 6:
    the twins against twins that sum the same exact bf16 products in
    float64, on chip_smoke.py's random trunk and rows (2,048 of them, din
    93, unit normal cotangent).  chip_smoke.py holds the kernels against
    the twins to TOL_MLP_*; each measure here must stay within half of its
    limit, so that the limits leave room for the card's own order."""
    import chip_smoke as cs
    _, wb, bp = cs.random_trunk(torch, 93, "cpu", seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (2048, 93)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(2048, 256)).astype(np.float32))
    f32 = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    monkeypatch.setattr(MF, "_layer", lambda h, w: (h.double() @ w.double()).float())
    f64 = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    rel = {}
    for name, a, b in zip(("out", "dx", "dW", "db"), f32, f64):
        d = a.double() - b.double()
        rel[name] = (float(d.abs().max() / b.abs().max()), float(d.norm() / b.double().norm()))
    assert rel["out"][0] > 0, "float64 sums changed nothing: the test is not testing"
    assert rel["out"][0] <= cs.TOL_MLP_FWD_MAX / 2 and rel["out"][1] <= cs.TOL_MLP_FWD_NORM / 2
    for name in ("dx", "dW", "db"):
        assert rel[name][1] <= cs.TOL_MLP_BWD_NORM / 2, (name, rel[name])
    for name in ("dW", "db"):
        assert rel[name][0] <= cs.TOL_MLP_BWD_MAX / 2, (name, rel[name])


# --- chip_smoke.py's gate for kernels 5 and 6 (trunk_measures) ------------------

def _gate_rows(seed, repeated):
    """chip_smoke.py's random trunk (din 93) on 2,048 seeded rows, row 0 and
    its cotangent copied onto about a share ``repeated`` of the others (as
    the dead Gaussian slots repeat one input row), and the twins' outputs.
    Returns (chip_smoke, x, wb, bp, g, the copies' mask, twins' outputs)."""
    import chip_smoke as cs
    _, wb, bp = cs.random_trunk(torch, 93, "cpu", seed=seed)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.uniform(-1, 1, (2048, 93)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(2048, 256)).astype(np.float32))
    copies = torch.tensor(rng.random(2048) < repeated)
    copies[0] = True
    x[copies], g[copies] = x[0].clone(), g[0].clone()
    return cs, x, wb, bp, g, copies, [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]


def _all_rows_measures(got, want):
    """The gate's measures with every ratio over all rows, as compare_trunk
    took them before it grouped equal rows."""
    rep = {}
    for name, a, b in zip(("out", "dx", "dW", "db"), got, want):
        fin = torch.isfinite(b)
        d = torch.where(fin, a.double() - b.double(), 0.0)
        bf = torch.where(fin, b.double(), 0.0)
        rep[name] = (float(d.abs().max()) / max(float(bf.abs().max()), 1e-30),
                     float(d.norm()) / max(float(bf.norm()), 1e-30), float(d.abs().max()))
    return rep


def _one_ulp_down_the_layers(x, wb, bp, layer):
    """Row x's trunk output when its largest activation of ``layer`` rounds
    to the next bf16 value up and the change runs down the later layers, as
    the twins compute them: how a sum in another order moves a row."""
    xb, acts = MF._forward_acts(x[None], wb, bp)
    h = acts[layer].clone()
    h.view(torch.int16)[0, int(h.float().abs().argmax())] += 1
    for i in range(layer + 1, DEPTH):
        y = MF._layer(h, wb[i])
        if i == SKIP + 1:
            y = y + MF._layer(xb, wb[DEPTH][:x.shape[0]])
        h = torch.relu(y + bp[i]).to(torch.bfloat16)
    return h.float()[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trunk_gate_on_distinct_rows_is_the_all_rows_measure(seed, monkeypatch):
    """On rows that are all distinct, the grouped measures are those over
    all rows to the bit, so test_twins_summation_order_spread still
    calibrates the limits; the 'kernel' here is the twin summing in
    float64."""
    cs, x, wb, bp, g, _, want = _gate_rows(seed, 0.0)
    monkeypatch.setattr(MF, "_layer", lambda h, w: (h.double() @ w.double()).float())
    got = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    ok, rep, groups = cs.trunk_measures(torch, x, g, got, want)
    old = _all_rows_measures(got, want)
    assert groups == {"out": (2048, True), "dx": (2048, True)}
    assert rep["out"][1] > 0
    for name in ("out", "dx", "dW", "db"):
        assert rep[name][:3] == old[name] and rep[name][3] == old[name][1], name
    assert ok


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trunk_gate_weighs_a_repeated_row_once(seed):
    """Row 0 on ~90% of the rows, its 'kernel' output one bf16 rounding
    away from the twin's in layer 2 (every copy alike): the norm over all
    rows is that one row's own error and fails the limit (the defect of the
    gate before rows were grouped, which failed phase 8 on the card), the
    grouped gate passes."""
    cs, x, wb, bp, g, copies, want = _gate_rows(seed, 0.9)
    got = [w.clone() for w in want]
    got[0][copies] = _one_ulp_down_the_layers(x[0], wb, bp, 2)
    ok, rep, groups = cs.trunk_measures(torch, x, g, got, want)
    old = _all_rows_measures(got, want)["out"][1]
    assert old > cs.TOL_MLP_FWD_NORM and rep["out"][3] == old
    assert groups["out"] == (2048 - int(copies.sum()) + 1, True)
    assert groups["dx"] == groups["out"]
    assert rep["out"][1] <= cs.TOL_MLP_FWD_NORM / 4 and ok, rep


def test_trunk_gate_fails_a_live_row_five_percent_off():
    """A 5% error on one distinct row, among ~90% copies of row 0, fails the
    grouped norm; over all rows the copies drowned it."""
    cs, x, wb, bp, g, copies, want = _gate_rows(0, 0.9)
    got = [w.clone() for w in want]
    live = int(torch.nonzero(~copies & (want[0] > 0).any(1))[0, 0])
    got[0][live] *= 1.05
    ok, rep, _ = cs.trunk_measures(torch, x, g, got, want)
    assert not ok and rep["out"][1] > cs.TOL_MLP_FWD_NORM, rep
    assert _all_rows_measures(got, want)["out"][1] <= cs.TOL_MLP_FWD_NORM


@pytest.mark.parametrize("output", ["out", "dx"])
def test_trunk_gate_fails_a_copy_unlike_its_siblings(output):
    """One copy of the repeated row whose output differs from its group's
    first row by one float32 ulp in one element: every limit holds, the
    same-bits check fails."""
    cs, x, wb, bp, g, copies, want = _gate_rows(0, 0.9)
    got = [w.clone() for w in want]
    k = {"out": 0, "dx": 1}[output]
    copy = int(torch.nonzero(copies)[1, 0])
    j = int(got[k][copy].abs().argmax())
    got[k][copy, j] = torch.nextafter(got[k][copy, j], torch.tensor(float("inf")))
    ok, rep, groups = cs.trunk_measures(torch, x, g, got, want)
    assert rep["out"][0] <= cs.TOL_MLP_FWD_MAX and rep["out"][1] <= cs.TOL_MLP_FWD_NORM
    assert rep["dx"][1] <= cs.TOL_MLP_BWD_NORM
    assert groups[output][1] is False and groups[{"out": "dx", "dx": "out"}[output]][1] is True
    assert not ok


def test_trunk_gate_keeps_nan_rows_apart_and_checks_their_place():
    """A NaN in lane 3 of every seventh row, copies of row 0 among them: a
    NaN row is equal to nothing, so each is a group of its own; the twin's
    NaN rows pass, and a row where the 'kernel' lost its NaN fails."""
    cs, x, wb, bp, g, copies, _ = _gate_rows(0, 0.9)
    x[::7, 3] = float("nan")
    want = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    nan = torch.zeros(2048, dtype=torch.bool)
    nan[::7] = True
    assert torch.equal(torch.isnan(want[0]).all(1), nan)
    distinct = int(nan.sum()) + 1 + int((~nan & ~copies).sum())
    if not bool((~nan & copies).any()):
        distinct -= 1
    first, reps = cs.row_groups(torch, x)
    assert reps.numel() == distinct and torch.equal(first[nan], torch.nonzero(nan)[:, 0])
    ok, _, groups = cs.trunk_measures(torch, x, g, want, want)
    assert ok and groups["out"] == (distinct, True)
    got = [w.clone() for w in want]
    got[0][7] = 0.0
    assert not cs.trunk_measures(torch, x, g, got, want)[0]


def test_transposed_pack_is_each_matrix_transposed():
    """Kernel 6's row pass reads the forward's weights from the transposed
    pack: matrix m of it holds W[m]ᵀ, contiguous, so that a 64-column slice
    of its rows n is the forward's B[n][k0:k0+64] = W[m][k0:k0+64, n]."""
    rng = np.random.default_rng(5)
    w = torch.tensor(rng.normal(size=(9, 256, 256)).astype(np.float32)).to(torch.bfloat16)
    wt = MF.transpose_pack(w)
    assert wt.shape == w.shape and wt.dtype == torch.bfloat16 and wt.is_contiguous()
    for m, k, n in ((0, 3, 200), (5, 255, 0), (8, 64, 17)):
        assert torch.equal(wt[m, n, k], w[m, k, n])
    assert torch.equal(wt[4, :, 64:128], w[4, 64:128, :].t())


def test_wrappers_take_the_twins_on_the_cpu_and_check_their_inputs():
    """On CPU tensors the wrappers return the twins' results and count no
    launch; wrong shapes or types raise."""
    rng = np.random.default_rng(4)
    ws, bs = _weights(rng, 30)
    wpack, bpack = _pack(ws, bs)
    wb, bp = torch.tensor(wpack).to(torch.bfloat16), torch.tensor(bpack)
    x = torch.tensor(rng.uniform(-1, 1, (9, 30)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(9, 256)).astype(np.float32))
    f0, b0 = MF.trunk_fwd.launches, MF.trunk_bwd.launches
    assert torch.equal(MF.trunk_fwd(x, wb, bp), MF.trunk_fwd_ref(x, wb, bp))
    for u, v in zip(MF.trunk_bwd(x, wb, bp, g), MF.trunk_bwd_ref(x, wb, bp, g)):
        assert torch.equal(u, v)
    assert (MF.trunk_fwd.launches, MF.trunk_bwd.launches) == (f0, b0)
    with pytest.raises(TypeError):
        MF.trunk_fwd(x, wb.float(), bp)
    with pytest.raises(ValueError):
        MF.trunk_fwd(torch.zeros((9, 257)), wb, bp)
    with pytest.raises(ValueError):
        MF.trunk_fwd(x, wb[:8], bp)
    with pytest.raises(ValueError):
        MF.trunk_bwd(x, wb, bp, g[:, :128])
    with pytest.raises(ValueError):
        MF.trunk_bwd(x, wb, bp, g.double())
    with pytest.raises(TypeError):
        MF.trunk_bwd(x, wb.float(), bp, g)
    with pytest.raises(ValueError):
        MF.trunk_bwd(torch.zeros((9, 257)), wb, bp, g)
    wt = MF.transpose_pack(wb)
    ws = MF.stage_pack(wt)
    assert torch.equal(MF.trunk_fwd(x, wb, bp, ws), MF.trunk_fwd_ref(x, wb, bp))
    for u, v in zip(MF.trunk_bwd(x, wb, bp, g, wt), MF.trunk_bwd_ref(x, wb, bp, g)):
        assert torch.equal(u, v)
    for bad in (wt, ws[:35], ws.float(), ws.transpose(1, 2)):
        with pytest.raises(ValueError):
            MF.trunk_fwd(x, wb, bp, bad)
    for bad in (ws, wt[:8], wt.float(), wt.transpose(1, 2)):
        with pytest.raises(ValueError):
            MF.trunk_bwd(x, wb, bp, g, bad)


def test_stage_pack_is_the_swizzled_stages():
    """Kernel 5 copies each weight stage into shared memory as one block:
    stage 4·m + k of the stage pack holds rows n, columns 64k.. of W[m]ᵀ,
    with the 8-element granule g of row n at granule g ^ (n % 8), the
    128-byte swizzle of the kernel's tiles."""
    rng = np.random.default_rng(7)
    w = torch.tensor(rng.normal(size=(9, 256, 256)).astype(np.float32)).to(torch.bfloat16)
    ws = MF.stage_pack(MF.transpose_pack(w))
    assert ws.shape == (36, 256, 64) and ws.dtype == torch.bfloat16 and ws.is_contiguous()
    flat = ws.reshape(36, 256 * 64)
    for m, k, n, c in ((0, 0, 0, 0), (8, 3, 255, 63), (5, 1, 9, 17), (2, 2, 100, 40)):
        assert flat[4 * m + k, n * 64 + ((c // 8) ^ (n % 8)) * 8 + c % 8] == w[m, 64 * k + c, n]
    n = torch.arange(256)[:, None]
    plain = ws.reshape(9, 4, 256, 8, 8)[:, :, n, torch.arange(8)[None, :] ^ (n % 8)]
    assert torch.equal(plain.reshape(9, 4, 256, 64).permute(0, 1, 3, 2).reshape(9, 256, 256), w)


def test_fused_trunk_transposes_the_pack_once(monkeypatch):
    """FusedTrunk makes the transposed pack once in its forward, hands its
    stage pack to kernel 5 and, from the saved tensors, that same transposed
    pack to kernel 6; the results are the twins'."""
    rng = np.random.default_rng(6)
    ws, bs = _weights(rng, 30)
    wpack, bpack = (torch.tensor(a) for a in _pack(ws, bs))
    x = torch.tensor(rng.uniform(-1, 1, (9, 30)).astype(np.float32), requires_grad=True)
    g = torch.tensor(rng.normal(size=(9, 256)).astype(np.float32))
    made, seen = [], []
    real_t, real_f, real_b = MF.transpose_pack, MF.trunk_fwd, MF.trunk_bwd
    monkeypatch.setattr(MF, "transpose_pack", lambda w: made.append(real_t(w)) or made[-1])
    monkeypatch.setattr(MF, "trunk_fwd", lambda *a: seen.append(a[3]) or real_f(*a))
    monkeypatch.setattr(MF, "trunk_bwd", lambda *a: seen.append(a[4]) or real_b(*a))
    out = MF.FusedTrunk.apply(x, wpack, bpack)
    dx, = torch.autograd.grad(out, [x], g)
    assert len(made) == 1 and len(seen) == 2 and seen[1] is made[0]
    wb = wpack.to(torch.bfloat16)
    assert torch.equal(made[0], real_t(wb)) and torch.equal(seen[0], MF.stage_pack(made[0]))
    assert torch.equal(out, MF.trunk_fwd_ref(x.detach(), wb, bpack))
    assert torch.equal(dx, MF.trunk_bwd_ref(x.detach(), wb, bpack, g)[0])


# --- MLPTrunk in its three modes against flax's ----------------------------------------

JAX_TRUNK = {"f32": dict(dtype=None, fuse=False), "bf16": dict(dtype=jnp.bfloat16, fuse=False),
             "fused": dict(dtype=jnp.bfloat16, fuse=True)}


@pytest.mark.parametrize("din", [93, 84])
@pytest.mark.parametrize("mode", ["f32", "bf16", "fused"])
def test_trunk_modes_match_flax(mode, din):
    """The port's MLPTrunk(mode) against flax's MLPTrunk at the matching
    (dtype, fuse), the same weights, 64 rows: the output, and the gradients
    of Σ out·g to the input and to every w{i}/b{i} (through pack_trunk in
    fused mode).  f32: output 1e-5, gradients 1e-5 of each leaf's largest
    value (float32 sums in other orders).  bf16 and fused, on the clean
    rows (the cotangent zero elsewhere): the output exactly; the gradients
    to 2e-2 (bf16 mode: every backward product is rounded to bf16 on both
    sides, and a one-ulp difference, 2^-8 relative, in one term carries
    into the sums) and 5e-3 (fused: the gmb flips of the twin test above)."""
    rng = np.random.default_rng(din + len(mode))
    ws, bs = _weights(rng, din)
    x = rng.uniform(-1, 1, (64, din)).astype(np.float32)
    if mode == "f32":
        clean = np.ones(64, bool)
    elif mode == "bf16":
        clean = _clean_rows(_port_acts(x, ws, bs, mode), _jax_dense_acts(x, ws, bs))
    else:
        wpack, bpack = _pack(ws, bs)
        clean = _clean_rows(_port_acts(x, ws, bs, mode),
                            _jax_fused_acts(np.pad(x, ((0, 0), (0, 256 - din))), wpack, bpack))
    g = rng.normal(size=(64, 256)).astype(np.float32) * clean[:, None]

    jt = JM.MLPTrunk(**JAX_TRUNK[mode])
    params = {"params": {**{f"w{i}": jnp.asarray(w) for i, w in enumerate(ws)},
                         **{f"b{i}": jnp.asarray(b) for i, b in enumerate(bs)}}}
    out, vjp = jax.vjp(lambda p, a: jt.apply(p, a), params, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    out = np.asarray(out)

    trunk = _port_trunk(ws, bs)
    tx = torch.tensor(x, requires_grad=True)
    tout = trunk(tx, mode)
    assert tout.dtype == torch.float32
    grads = torch.autograd.grad(tout, [tx] + list(trunk.parameters()), torch.tensor(g))
    tout = tout.detach().numpy()

    want = [np.asarray(gx)]
    for i in range(DEPTH):
        want += [np.asarray(gp["params"][f"w{i}"]).T, np.asarray(gp["params"][f"b{i}"])]
    if mode == "f32":
        np.testing.assert_allclose(tout, out, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(tout[clean], out[clean])
    tol = {"f32": 1e-5, "bf16": 2e-2, "fused": 5e-3}[mode]
    for k, (got, w) in enumerate(zip(grads, want)):
        got = got.numpy()
        assert got.shape == w.shape, k
        np.testing.assert_allclose(got, w, rtol=0, atol=tol * np.abs(w).max() + 1e-9,
                                   err_msg=f"leaf {k}")
    assert all(np.abs(w).max() > 0 for w in want)


def test_fused_blender_deform_network_matches_jax():
    """A blender DeformNetwork (bf16 timenet, 63 + 30 = 93 input lanes) in
    fused mode against flax's (bf16, fuse=True), converted weights, 48 rows
    at one time value: the four heads' outputs.  A bf16 flip in the timenet
    or the trunk (see the module docstring) moves a row's heads by a few
    bf16 ulps of the trunk output times the head weights: 2e-3 of each
    output's largest value, with 90% of the elements within 1e-6 of it."""
    from dgmesh_torch import convert
    rng = np.random.default_rng(11)
    jnet = JM.DeformNetwork(is_blender=True, with_normal=True, dtype=jnp.bfloat16, fuse=True,
                            zero_init_heads=False)
    xyz = rng.uniform(-0.5, 0.5, (48, 3)).astype(np.float32)
    t = np.full((48, 1), 0.3, np.float32)
    params = jnet.init(jax.random.PRNGKey(2), jnp.asarray(xyz), jnp.asarray(t))
    want = [np.asarray(o) for o in jnet.apply(params, jnp.asarray(xyz), jnp.asarray(t))]
    net = TM.DeformNetwork(is_blender=True, with_normal=True, zero_init_heads=False)
    convert.load_flax_params(net, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = [o.numpy() for o in net(torch.tensor(xyz), torch.tensor(t), "fused")]
        f32 = [o.numpy() for o in net(torch.tensor(xyz), torch.tensor(t), "f32")]
    for g, w, f in zip(got, want, f32):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-3 * scale)
        assert (np.abs(g - w) <= 1e-6 * scale).mean() >= 0.9
        assert np.abs(f - w).max() > 1e-5 * scale       # bf16, not float32


# --- the precision policy (tests/test_mixed_precision.py's counterpart) -------------------

def _ctx(bf16, fused):
    cfg = Config()
    cfg.model.is_blender = True
    cfg.model.grid_res = 16
    cfg.tpu.max_gaussians = 128
    cfg.tpu.max_verts, cfg.tpu.max_faces = 256, 512
    cfg.tpu.mlp_bf16, cfg.tpu.mlp_fused = bf16, fused
    return StepContext(cfg, 32, 32, device="cpu")


def test_mlp_mode_and_f32_view():
    """mlp_mode follows JAX's build_nets (fused only with bf16); f32() is the
    context itself when the nets are float32, else a cached, idempotent view
    in float32 that shares every other piece."""
    assert _ctx(False, False).mlp_mode == "f32" and _ctx(False, True).mlp_mode == "f32"
    assert _ctx(True, False).mlp_mode == "bf16"
    ctx = _ctx(True, True)
    assert ctx.mlp_mode == "fused"
    f = _ctx(False, False)
    assert f.f32() is f
    v = ctx.f32()
    assert v is not ctx and v is ctx.f32() and v.f32() is v
    assert v.mlp_mode == "f32" and ctx.mlp_mode == "fused"
    assert v.dpsr is ctx.dpsr and v.mr_cfg is ctx.mr_cfg and v.splat_cfg is ctx.splat_cfg


def test_render_frame_is_float32_under_bf16_configs():
    """render_frame under a bf16 and a bf16+fused config equals the float32
    config's bit for bit (the nets apply through ctx.f32()), while the
    training step's modes are not a no-op: the same net differs in bf16."""
    from torch_parity_fixture import jax_fixture, port_batch, port_fixture
    from dgmesh_torch.eval.testing import render_frame

    cfg, img, _, state, batch = jax_fixture(head_std=1e-2, seed=3)
    outs = []
    for bf16, fused in ((False, False), (True, False), (True, True)):
        cfg.tpu.mlp_bf16, cfg.tpu.mlp_fused = bf16, fused
        _, ctx, tstate, _ = port_fixture(cfg, img, state)
        outs.append(render_frame(ctx, tstate, port_batch(batch), 1))
    for other in outs[1:]:
        for k in ("render", "mesh_image", "mask", "verts", "vtx_color"):
            assert torch.equal(other[k], outs[0][k]), k
    net = tstate.nets.deform
    xyz = tstate.gp.xyz[:64]
    tt = torch.full((64, 1), 0.3)
    with torch.no_grad():
        h = {m: net.features(xyz, tt, m) for m in ("f32", "bf16", "fused")}
    assert float((h["bf16"] - h["f32"]).abs().max()) > 0
    assert float((h["fused"] - h["f32"]).abs().max()) > 0
