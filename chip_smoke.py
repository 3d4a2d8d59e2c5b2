#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dgmesh_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

    python3 chip_smoke.py --kernels-only   # phases 1-3, then stop (no result)
    python3 chip_smoke.py --profile        # profile a float32 and a fused step

Phases; any failure exits non-zero and prints no result:
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds every kernel of the render and training paths
                from dgmesh_torch/csrc (one nvcc per source, in parallel);
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the main path's full-width shapes, on seeded random rows with
                the edge cases (invalid rows, alpha-clamped rows, slivers
                below AREA_MIN, back faces, exact z ties; for the backward
                kernels random cotangents, and built ties where the shade
                backward splits gradients in half); the fused trunk
                (kernels 5 and 6) at 131,072 and 479,966 (ragged) rows;
  4. render   — configs/synthetic-quality-288.yaml with bench.py's shell
                state (100k Gaussians, radius 0.45, seed 0) and seeded random
                nets: render_frame for 4 orbit views at 800², grid 288, with
                the launch counters zeroed just before and read just after;
                then render_frame on the first view again with each function
                it calls wrapped to time it (where the time goes) and to keep
                the kernels' inputs, on which the kernels are held against
                their twins again and timed; then one render at the YAML's own
                gaussian_ratio and init_density_threshold, reported only;
  5. train    — the mesh-phase training step (train/step.py::train_step,
                bench.py's flags, densify statistics on) on bench.py's view
                with a random GT image: 1 warm-up and 5 timed steps, each
                from the same frozen state, every step finite with
                mesh_overflow 0 and no non-finite gradient leaf, the four
                launch counters zeroed just before and read just after; then
                two steps with forward / backward / optimizer timed, and the
                backward kernels held against their twins on the rows and
                cotangents they got inside the step (each cotangent scaled
                to a largest |value| of 1); all four kernels timed, each
                beside the bound of the work its function needs on these
                rows;
     5f: the same in the fused configuration (tpu.mlp_bf16 and
                tpu.mlp_fused set here): every kernel counted, kernels 5 and
                6 six times a step; the stages; kernels 5 and 6 held against
                their twins on every trunk call of a step (cotangents scaled
                to 1), timed on the largest beside their bound and the bf16
                mode's chain of cuBLAS GEMMs;
     5g: the bf16 (cuBLAS) configuration, bench.py's own precision:
                the same steps and checks and the stages, reported; then the
                three steps side by side;
  6. check    — render, and a training step from each of SMALL_SEEDS
                states, on the card and on the CPU (the plain twins) at a
                small size with room in the mesh caps must agree; the
                training step again in the fused configuration, from
                SMALL_SEEDS_FUSED states;
  7. result   — one JSON line of per-kernel numbers, then the last line
                {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "synthetic-quality-288.yaml")

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and device memory bandwidth.  Used only for bound_ms.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# ... and the dense bf16 tensor-core rate (NVIDIA H100 SXM data sheet,
# without sparsity), the bound of kernels 5 and 6
PEAK_BF16_TC = 989e12

# Float32 operations the function needs, counted from the kernels' source
# (an exp, log1p, sqrt, division, compare or select counts as one
# operation; a sum over the tile's pixels as one add per summand).  The
# forward, per (pixel, row) pair:
COMPOSITE_TEST_OPS = 16     # every valid row: power, exp, clamp, the tests
COMPOSITE_ACCUM_OPS = 11    # rows that pass the tests: log1p, exp, rgb sums
SHADE_OPS = 118             # every valid row: edges, barycentrics, z, soft
# The backward functions: the forward's recompute once (the counts above),
# then partials and their tile sums only where they are not zero; not the
# second walk over the rows that the kernels' design adds:
COMPOSITE_BWD_PASS_OPS = 20   # pairs that pass the alpha tests: log1p, the
                              # transmittance, w, u, the suffix sum, d rgb + 3 sums
COMPOSITE_BWD_LIVE_OPS = 34   # of these, pairs below the 0.99 clamp: d alpha,
                              # d power, the six partials + 6 sums
SHADE_BWD_SOFT_OPS = 159      # pairs with a non-zero soft gradient: picks, the
                              # gates, three edges' clip weights and partials + 6 sums
SHADE_BWD_RGB_OPS = 117       # pixels with a winner and a non-zero g_rgb: the
                              # normaliser, u, dq, the winner row's 18 partials + 18 sums

SOURCES = {"composite_tiles": "dgmesh_torch/csrc/composite.cu",
           "composite_bwd": "dgmesh_torch/csrc/composite_bwd.cu",
           "shade_tiles": "dgmesh_torch/csrc/shade.cu",
           "shade_bwd": "dgmesh_torch/csrc/shade_bwd.cu",
           "trunk_fwd": "dgmesh_torch/csrc/mlp_fwd.cu",
           "trunk_bwd": "dgmesh_torch/csrc/mlp_bwd.cu"}
REPLACES = {"composite_tiles": "dgmesh_tpu/ops/splat_pallas.py:34",
            "composite_bwd": "dgmesh_tpu/ops/splat_pallas.py:116",
            "shade_tiles": "dgmesh_tpu/ops/mesh_raster_pallas.py:40",
            "shade_bwd": "dgmesh_tpu/ops/mesh_raster_pallas.py:164",
            "trunk_fwd": "dgmesh_tpu/ops/mlp_pallas.py:36",
            "trunk_bwd": "dgmesh_tpu/ops/mlp_pallas.py:62"}

DEVICE = "cuda"
KERNELS_ONLY = "--kernels-only" in sys.argv[1:]   # build and check, then stop
PROFILE = "--profile" in sys.argv[1:]             # profile one training step, then stop
IMG = 800             # 800x800 views, 16x16 tiles: T = 2500
N_GAUSS = 100_000     # live Gaussians in the config's 131,072 slots
N_VIEWS = 4
REPEATS = 3
TRAIN_STEPS = 5       # timed training steps, after one warm-up, each from the same state
KERNEL_TIMING_LAUNCHES = 20
TOL_COMPOSITE = 1e-4  # rgb/alpha: sequential vs cumsum/einsum summation order
TOL_SHADE = 1e-5      # rgb/soft; hard and fid must agree exactly
TOL_SMALL = 1e-4      # card vs CPU at the small size: images
TOL_BWD_REL = 1e-4    # backward kernels vs twins, per lane group: relative to
TOL_BWD_ABS = 1e-6    # the group's largest |twin| value, plus an absolute floor
TOL_SMALL_LOSS = 1e-4  # card vs CPU training step: loss terms, relative
TOL_SMALL_GP = 5e-3    # ... Gaussian gradient leaves, relative to the leaf's max
TOL_SMALL_HEAD = 1e-4  # ... the appearance net's output head (kernel 4's colour
                       #     gradient, no ReLU on the way), relative to the leaf's max
TOL_SMALL_NET = 3e-2   # ... the other net leaves, ‖Δ‖/‖CPU‖ per leaf (a ReLU at
                       #     float32 rounding of 0 may take the other side, and
                       #     every layer below it moves: tests/test_torch_train.py);
                       #     ~3x the largest of eight sound card runs (0.0047-0.0108)
SMALL_SEEDS = 6        # states (points and nets) of the small training check
# Kernels 5 and 6 against their twins.  Both sum exact bf16 products in
# float32 but in another order, so now and then an activation rounds to the
# neighbouring bf16 value and the change runs down the later layers, where
# it may move a pre-activation across 0 and flip a ReLU mask (the row's
# gradient then differs at that unit by its whole value).  The limits are
# at least twice how far summation order alone moves the twins on these
# weights and rows: the float32 twins against twins that sum in float64
# (tests/test_torch_mlp_fused.py::test_twins_summation_order_spread).  dx
# is not held element by element: a mask flip changes whole elements.
TOL_MLP_FWD_MAX = 2e-2    # output: max |Δ| / max |twin|
TOL_MLP_FWD_NORM = 2e-3   # output: ‖Δ‖ / ‖twin‖
TOL_MLP_BWD_NORM = 3e-2   # dx, dW, db: ‖Δ‖ / ‖twin‖
TOL_MLP_BWD_MAX = 1e-1    # dW, db: max |Δ| / max |twin|
MLP_ROWS = (131_072, 479_966)   # the step's Gaussian slots and mesh vertices
MLP_DIN = 93                    # blender nets: 63 position + 30 timenet lanes
TRUNKS = 6    # fused trunks per step: deform, deform_normal, the two cycle nets,
              # deform_back and appearance on the mesh vertices
# The small card-vs-CPU step in the fused configuration.  Card and CPU sum
# the trunk's bf16 products in other orders, so an activation may round to
# the neighbouring bf16 value and tip the ReLU masks below it (TOL_MLP_*).
# The loss limit is the float32 step's.  The appearance head sees the bf16
# trunk output, where a flip is one bf16 ulp of one element; the other net
# leaves move with every mask a flip tips; the Gaussian leaves take the
# appearance trunk's input gradient (kernel 6's dx) through the mesh
# vertices, where a tipped mask changes whole elements.  Each limit is
# 3-4x the worst of seeds 0-5 in the first card run of this check (head
# 2.89e-3, other leaves 4.69e-2, Gaussian leaves 6.93e-3: the float32
# step's 5e-3 for these, taken over unexamined, failed on one seed).
# Seeds 6-11 were added after the limits were set, as held-out states.
TOL_SMALL_HEAD_FUSED = 1e-2
TOL_SMALL_NET_FUSED = 2e-1
TOL_SMALL_GP_FUSED = 2e-2
SMALL_SEEDS_FUSED = 2 * SMALL_SEEDS


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# seeded random kernel inputs with the edge cases


def random_composite_attrs(rng, T, K, tiles_x, tile):
    a = np.zeros((T, K, 16), np.float32)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile)[:, None].astype(np.float32)
    oy = ((t // tiles_x) * tile)[:, None].astype(np.float32)
    a[..., 0] = ox + rng.uniform(-12, 28, (T, K))
    a[..., 1] = oy + rng.uniform(-12, 28, (T, K))
    ca = rng.uniform(0.005, 0.5, (T, K))
    cc = rng.uniform(0.005, 0.5, (T, K))
    a[..., 2] = ca
    a[..., 3] = rng.uniform(-0.9, 0.9, (T, K)) * np.sqrt(ca * cc)
    a[..., 4] = cc
    a[..., 5] = rng.uniform(0.0, 1.0, (T, K))
    a[..., 5][rng.random((T, K)) < 0.1] = 1.5          # alpha clamped at 0.99
    a[..., 6:9] = rng.uniform(0.0, 1.5, (T, K, 3))
    a[..., 9] = rng.random((T, K)) < 0.85              # invalid rows inside
    a[:, K - K // 8:, 9] = 0.0                         # and a padded tail
    return a


def random_shade_attrs(rng, T, K, tiles_x, tile):
    a = np.zeros((T, K, 24), np.float32)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile)[:, None, None].astype(np.float32)
    oy = ((t // tiles_x) * tile)[:, None, None].astype(np.float32)
    a[..., 0:6:2] = ox + rng.normal(8, 10, (T, K, 3))  # both windings: back faces
    a[..., 1:6:2] = oy + rng.normal(8, 10, (T, K, 3))
    sliver = rng.random((T, K)) < 0.05                 # |area| < AREA_MIN
    a[..., 4][sliver] = a[..., 0][sliver] + 1e-6 * (a[..., 2][sliver] - a[..., 0][sliver])
    a[..., 5][sliver] = a[..., 1][sliver] + 1e-6 * (a[..., 3][sliver] - a[..., 1][sliver])
    a[..., 6:9] = rng.uniform(0.2, 2.0, (T, K, 3))
    a[..., 9] = rng.random((T, K)) < 0.8
    a[..., 10:19] = rng.random((T, K, 9))
    a[..., 19] = rng.integers(0, 1 << 20, (T, K))
    tie = np.nonzero(rng.random(K - 1) < 0.1)[0]       # exact z ties: a copy
    a[:, tie + 1, :19] = a[:, tie, :19]                # with another face id
    a[:, K - K // 8:, 9] = 0.0
    return a


def shade_tie_attrs(rng, T, K, tiles_x, tile):
    """random_shade_attrs with built ties in every eighth row: a vertex on a
    pixel centre (uu exactly 0 and 1 on its two edges, d2 ties between
    them, and ties at every pixel whose nearest edge point is that vertex),
    a pixel centre in the middle of an edge (d2 exactly 0), and a triangle
    symmetric about a column of pixel centres (d2 ties between its two
    slanted edges).  Every edge has a power-of-two squared length and every
    coordinate is a pixel centre plus an integer, so d2, uu and the ties
    come out exact in float32 whatever the rounding of the arithmetic
    (with or without fused multiply-adds)."""
    a = random_shade_attrs(rng, T, K, tiles_x, tile)
    t = np.arange(T)
    ox = ((t % tiles_x) * tile).astype(np.float32)
    oy = ((t // tiles_x) * tile).astype(np.float32)
    for k in range(0, K - K // 8, 8):
        x0 = ox + rng.integers(0, tile, T) + 0.5
        y0 = oy + rng.integers(0, tile, T) + 0.5
        kind = (k // 8) % 3
        if kind == 0:      # vertex a on the pixel centre
            tri = [x0, y0, x0 + 4, y0 + 4, x0, y0 + 8]
        elif kind == 1:    # pixel centre in the middle of edge a-b
            tri = [x0 - 4, y0, x0 + 4, y0, x0, y0 + 4]
        else:              # symmetric about the column x0
            tri = [x0, y0 - 4, x0 - 4, y0, x0 + 4, y0]
        a[:, k, 0:6] = np.stack(tri, -1)
        a[:, k, 9] = 1.0
    return a


def random_trunk(torch, din, device, seed):
    """A flax-initialised 8x256 trunk (lecun-normal kernels) with seeded
    N(0, 0.05) biases in place of flax's zeros, so the bias add is
    exercised; with its bf16 pack and float32 biases."""
    from dgmesh_torch.models.mlp import MLPTrunk
    from dgmesh_torch.ops import mlp_fused as MF
    gen = torch.Generator().manual_seed(seed)
    trunk = MLPTrunk(din, gen=gen)
    with torch.no_grad():
        for layer in trunk.layers:
            layer.bias.normal_(0.0, 0.05, generator=gen)
    trunk = trunk.to(device)
    wpack, bpack = MF.pack_trunk(trunk, din)
    return trunk, wpack.detach().to(torch.bfloat16).contiguous(), bpack.detach().contiguous()


def compare_trunk(torch, MF, x, wb, bp, g):
    """Kernels 5 and 6 against their twins on rows x and cotangent g.
    Returns (ok, {output: (max |Δ| / max |twin|, ‖Δ‖ / ‖twin‖, max |Δ|)})."""
    got = [MF.trunk_fwd(x, wb, bp), *MF.trunk_bwd(x, wb, bp, g)]
    want = [MF.trunk_fwd_ref(x, wb, bp), *MF.trunk_bwd_ref(x, wb, bp, g)]
    torch.cuda.synchronize()
    rep = {}
    for name, a, b in zip(("out", "dx", "dW", "db"), got, want):
        d = a.double() - b.double()
        rep[name] = (float(d.abs().max()) / max(float(b.abs().max()), 1e-30),
                     float(d.norm()) / max(float(b.double().norm()), 1e-30),
                     float(d.abs().max()))
    ok = (all(bool(torch.isfinite(a).all()) for a in got)
          and rep["out"][0] <= TOL_MLP_FWD_MAX and rep["out"][1] <= TOL_MLP_FWD_NORM
          and all(rep[k][1] <= TOL_MLP_BWD_NORM for k in ("dx", "dW", "db"))
          and all(rep[k][0] <= TOL_MLP_BWD_MAX for k in ("dW", "db")))
    return ok, rep


def trunk_report(rep):
    return ", ".join(f"{k} max {v[0]:.3g} norm {v[1]:.3g}" for k, v in rep.items())


def cotangents(rng, T, P):
    """Seeded random cotangents (T,P,3) and (T,P)."""
    return (rng.normal(size=(T, P, 3)).astype(np.float32),
            rng.normal(size=(T, P)).astype(np.float32))


# lane groups of d_attrs held to a tolerance each (the per-row sums over the
# tile's pixels run in another order in the kernels than in the twins)
COMPOSITE_GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "opacity": [5], "rgb": [6, 7, 8]}
SHADE_GROUPS = {"screen": list(range(6)), "inv_w": [6, 7, 8], "colour": list(range(10, 19))}
ZERO_LANES = {"composite": list(range(9, 16)), "shade": [9] + list(range(19, 24))}


def compare_bwd(torch, got, want, groups, zero_lanes, invalid):
    """Per lane group: max |kernel - twin| against 1e-4·max|twin| + 1e-6;
    the zero lanes and the invalid rows must be exactly 0 in the kernel's
    output.  Returns (max abs err, ok, {group: (err, tol)})."""
    torch.cuda.synchronize()
    rep, ok = {}, bool(torch.isfinite(got).all())
    for name, lanes in groups.items():
        g, w = got[..., lanes].double(), want[..., lanes].double()
        err = float((g - w).abs().max())
        tol = TOL_BWD_REL * float(w.abs().max()) + TOL_BWD_ABS
        rep[name] = (err, tol)
        ok = ok and err <= tol
    ok = ok and not bool(got[..., zero_lanes].any()) and not bool(got[invalid].any())
    return max(e for e, _ in rep.values()), ok, rep


# ---------------------------------------------------------------------------
# the work these rows need, for bound_ms


def composite_pairs(torch, SK, attrs, sc, chunk=100):
    """(pixel, row) pairs of composite rows, counted in tile chunks: of
    valid rows; of those the ones that pass the alpha tests (power <= 0,
    alpha >= 1/255); and of these the ones below the 0.99 clamp, whose
    d alpha the backward does not gate off."""
    T = attrs.shape[0]
    n_valid = int((attrs[..., 9] > 0.5).sum()) * sc.tile_h * sc.tile_w
    n_pass = n_live = 0
    px, py = SK.tile_pixels(T, sc.tiles_x, sc.tile_h, sc.tile_w, 0.0, attrs.device)
    with torch.no_grad():
        for s in range(0, T, chunk):
            at = attrs[s:s + chunk]
            dx = at[..., 0:1] - px[s:s + chunk, None]
            dy = at[..., 1:2] - py[s:s + chunk, None]
            pw = -0.5 * (at[..., 2:3] * dx * dx + at[..., 4:5] * dy * dy) - at[..., 3:4] * dx * dy
            raw = at[..., 5:6] * torch.exp(pw)
            ok = ((at[..., 9:10] > 0.5) & (pw <= 0)
                  & (torch.clamp_max(raw, SK.ALPHA_MAX) >= SK.ALPHA_MIN))
            n_pass += int(ok.sum())
            n_live += int((ok & (raw < SK.ALPHA_MAX)).sum())
    return n_valid, n_pass, n_live


def shade_pairs(torch, SK, attrs, g_rgb, g_soft, mc, chunk=16):
    """What the shade backward must compute on these rows and cotangents,
    counted in tile chunks with the plain twin's formulas: the (pixel, row)
    pairs of valid rows; those whose soft-path gradient is not zero
    (g_soft·e^M·s, gated by s <= 1 - 1e-6); and the pixels with a z-buffer
    winner and a non-zero g_rgb, where the rgb path runs."""
    T = attrs.shape[0]
    n_valid = int((attrs[..., 9] > 0.5).sum()) * mc.tile_h * mc.tile_w
    n_soft = n_rgb = 0
    px_all, py_all = SK.tile_pixels(T, mc.tiles_x, mc.tile_h, mc.tile_w, 0.5, attrs.device)
    with torch.no_grad():
        for s in range(0, T, chunk):
            a = attrs[s:s + chunk]
            px, py = px_all[s:s + chunk, None, :], py_all[s:s + chunk, None, :]
            ax, ay, bx, by, cx, cy = (a[..., i:i + 1] for i in range(6))
            valid = a[..., 9:10] > 0.5
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            live = area.abs() >= 1e-4
            area = torch.where(live, area, 1.0)
            inside = valid & live
            d2min = None
            for vx0, vy0, vx1, vy1 in ((ax, ay, bx, by), (bx, by, cx, cy), (cx, cy, ax, ay)):
                # the edge function of the vertex opposite this edge, and
                # the squared distance to the segment
                inside = inside & (((vx1 - vx0) * (py - vy0) - (vy1 - vy0) * (px - vx0))
                                   / area >= 0.0)
                ex, ey, qx, qy = vx1 - vx0, vy1 - vy0, px - vx0, py - vy0
                t = torch.clamp((qx * ex + qy * ey) / torch.clamp_min(ex * ex + ey * ey, 1e-12),
                                0.0, 1.0)
                d2 = (qx - t * ex) ** 2 + (qy - t * ey) ** 2
                d2min = d2 if d2min is None else torch.minimum(d2min, d2)
            dist = torch.sqrt(d2min + 1e-12)
            sg = torch.where(valid, torch.sigmoid(torch.where(inside, dist, -dist) / mc.sigma),
                             0.0)
            m = torch.log1p(-torch.clamp(sg, 0.0, 1.0 - 1e-6)).sum(1, keepdim=True)
            gs = -g_soft[s:s + chunk, None, :] * torch.exp(m) / mc.sigma
            n_soft += int(((gs * sg * ((sg <= 1.0 - 1e-6) & valid)) != 0).sum())
            n_rgb += int((inside.any(1) & (g_rgb[s:s + chunk] != 0).any(-1)).sum())
    return n_valid, n_soft, n_rgb


# ---------------------------------------------------------------------------
# timing


def time_cuda(torch, fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def max_err(a, b):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def compare_composite(torch, SK, attrs, geo):
    got = SK.composite_tiles(attrs, *geo)
    want = SK.composite_tiles_ref(attrs, *geo)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = all(bool(torch.isfinite(x).all()) for x in got) and err <= TOL_COMPOSITE
    return err, ok


def compare_shade(torch, MK, attrs, geo, sigma):
    got = MK.shade_tiles(attrs, *geo, sigma)
    want = MK.shade_tiles_ref(attrs, *geo, sigma)
    torch.cuda.synchronize()
    err = max_err((got[0], got[2]), (want[0], want[2]))
    exact = bool(torch.equal(got[1], want[1])) and bool(torch.equal(got[3], want[3]))
    n_fid = int((got[3] != want[3]).sum())
    ok = all(bool(torch.isfinite(x).all()) for x in got) and err <= TOL_SHADE and exact
    return err, ok, n_fid


# ---------------------------------------------------------------------------
# state


def perturb_heads(torch, nets, gen, std=1e-4):
    """Seeded noise on the zero-initialised offset heads, so the deformation
    is not identically zero."""
    with torch.no_grad():
        for net in nets:
            for name, mod in net.named_modules():
                if name.startswith("head_") and not mod.weight.any():
                    mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen,
                                                 device=gen.device) * std)
                    mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen,
                                               device=gen.device) * std)


def build_shell_state(torch, cfg, n_gauss, device, seed=0):
    """bench.py's frozen mesh-phase state: a noisy spherical shell of radius
    0.45-0.5 with outward normals and log-scale 0.01 (bench.py:100-114)."""
    from dgmesh_torch.train.state import init_state

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_gauss, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 0.45 + 0.05 * rng.random((n_gauss, 1))
    pts = (d * r).astype(np.float32)
    cols = rng.random((n_gauss, 3)).astype(np.float32)
    st = init_state(cfg, pts, cols, seed=seed, device=device)
    alive = st.gs.alive[:, None]
    normal = torch.zeros_like(st.gp.normal)
    normal[:n_gauss] = torch.as_tensor(d, dtype=torch.float32)
    gp = st.gp._replace(normal=normal * alive,
                        scaling=torch.where(alive, math.log(0.01), st.gp.scaling))
    st = st._replace(gp=gp)
    perturb_heads(torch, st.nets, torch.Generator(device=device).manual_seed(seed))
    return st


def call_by_stage(torch, targets, call, repeats, what="render_frame", per_call=None,
                  keep=None):
    """Run ``call`` ``repeats`` times with each ``(owner, attribute, stage)``
    of ``targets`` replaced by a wrapper that times its call between two
    synchronisations and keeps its arguments; the originals are put back
    after.  Returns ({stage: median over the repeats of its ms per call},
    median ms of the whole call, {stage: arguments of its last call}).  A
    stage is called once per call, or ``per_call[stage]`` times; otherwise
    this fails: the targets no longer match what ``what`` calls.  With a
    dict ``keep``, keep[stage] lists the arguments of each of its calls in
    the last repeat."""
    per_call = per_call or {}
    times = {stage: [] for _, _, stage in targets}
    args = {}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

    def timed(stage, fn):
        # functools.wraps carries a kernel wrapper's launch counter across:
        # the wrapper counts by its module-global name, which is ours here
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            times[stage].append((time.perf_counter() - t0) * 1e3)
            args[stage] = a
            if keep is not None:
                keep.setdefault(stage, []).append(a)
            return res
        return wrapper

    totals = []
    try:
        for (owner, attr, fn), (_, _, stage) in zip(saved, targets):
            setattr(owner, attr, timed(stage, fn))
        for r in range(repeats):
            if keep is not None:
                keep.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            totals.append((time.perf_counter() - t0) * 1e3)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    missing = [k for k, ts in times.items() if len(ts) != repeats * per_call.get(k, 1)]
    if missing:
        raise RuntimeError(f"{what} did not call {missing} "
                           f"{[per_call.get(k, 1) for k in missing]} times per call")
    per_repeat = {k: [sum(ts[i * per_call.get(k, 1):(i + 1) * per_call.get(k, 1)])
                      for i in range(repeats)] for k, ts in times.items()}
    return ({k: statistics.median(ts) for k, ts in per_repeat.items()},
            statistics.median(totals), args)


def bench_batch(W, H, device, seed=0):
    """bench.py's training view: the frontal camera at distance 2.5, fovx
    0.8, fid 0.5, time interval 0.01, a seeded random GT image and an
    all-ones mask (bench.py:116-121)."""
    from dgmesh_torch.cameras import camera_from_c2w_blender
    from dgmesh_torch.train.step import make_batch

    rng = np.random.default_rng(seed)
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = 2.5
    img = rng.random((H, W, 3)).astype(np.float32)
    cam = camera_from_c2w_blender(0, c2w, 0.8, W, H, 0.5, image=img,
                                  alpha_mask=np.ones((H, W, 1), np.float32))
    return make_batch(cam, 0.01, np.zeros(3, np.float32), device=device)


def train_flags(step, sh_degree):
    """bench.py's mesh-phase flags, with the densify statistics on."""
    return step.StepFlags(warm=False, mesh=True, freeze_pos=False, use_normal=True,
                          densify_stats=True, sh_degree=sh_degree)


def step_problems(torch, m):
    """What is wrong with one training step's metrics, as a list."""
    bad = [k for k in ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss",
                       "img_loss") if not bool(torch.isfinite(m[k]))]
    bad += [f"{k} {int(m[k])}" for k in ("mesh_overflow", "nonfinite_grad_leaves")
            if int(m[k]) != 0]
    bad += [f"{k} 0" for k in ("mesh_n_verts", "mesh_n_faces") if int(m[k]) == 0]
    return bad


def view_batches(cfg_w, cfg_h, n, device, radius=2.5, fovx=0.8):
    from dgmesh_torch.cameras import camera_from_c2w_blender, orbit_camera_poses
    from dgmesh_torch.train.step import make_batch

    poses = orbit_camera_poses(n, radius=radius, elevation=0.35)
    out = []
    for i, c2w in enumerate(poses):
        fid = i / max(n - 1, 1)
        cam = camera_from_c2w_blender(i, c2w, fovx, cfg_w, cfg_h, fid)
        out.append(make_batch(cam, 0.01, np.zeros(3, np.float32), device=device))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import dgmesh_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run it from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    from dgmesh_torch.config import Config
    from dgmesh_torch.device import resolve_device
    from dgmesh_torch.eval import testing
    from dgmesh_torch.eval.testing import render_frame_with_aux
    from dgmesh_torch.ops import cuda_build
    from dgmesh_torch.ops import mesh_raster as MR
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.ops import splat
    from dgmesh_torch.ops import splat_kernels as SK
    from dgmesh_torch.train import step
    from dgmesh_torch.train.step import StepContext

    dev = resolve_device(DEVICE)
    failures = []

    # 1. card ----------------------------------------------------------------
    card = card_line()
    log(card)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"# build: {time.perf_counter() - t0:.2f} s wall "
        + ", ".join(f"{n} {s:.2f} s" for n, s in cuda_build.build_seconds.items()))
    for n, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"#   {n}: {line.strip()}")

    cfg = load_cfg()
    if PROFILE:
        return profile_train(torch, cfg, dev)

    # 3. kernels vs twins on seeded random rows at full width ----------------
    t = cfg.tpu
    W = H = IMG
    ctx = StepContext(cfg, W, H, device=dev)
    sc, mc = ctx.splat_cfg, ctx.mr_cfg
    geo_s = (sc.tiles_x, sc.tile_h, sc.tile_w)
    geo_m = (mc.tiles_x, mc.tile_h, mc.tile_w)
    rng = np.random.default_rng(0)
    errs = {"composite_tiles": [], "shade_tiles": []}
    a1 = torch.as_tensor(random_composite_attrs(rng, sc.num_tiles, sc.max_per_tile,
                                                sc.tiles_x, sc.tile_w), device=dev)
    e, ok = compare_composite(torch, SK, a1, geo_s)
    errs["composite_tiles"].append(e)
    log(f"# kernels/random: composite_tiles {tuple(a1.shape)} max_abs_err {e:.3g} "
        f"(tol {TOL_COMPOSITE}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("composite_tiles vs twin (random)")
    a2 = torch.as_tensor(random_shade_attrs(rng, mc.num_tiles, mc.max_per_tile,
                                            mc.tiles_x, mc.tile_w), device=dev)
    e, ok, nf = compare_shade(torch, MK, a2, geo_m, mc.sigma)
    errs["shade_tiles"].append(e)
    log(f"# kernels/random: shade_tiles {tuple(a2.shape)} max_abs_err {e:.3g} "
        f"(tol {TOL_SHADE}; hard/fid exact, {nf} fid mismatches) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("shade_tiles vs twin (random)")
    P = sc.tile_h * sc.tile_w
    errs["composite_bwd"], errs["shade_bwd"] = [], []
    g1, g2 = (torch.as_tensor(x, device=dev) for x in cotangents(rng, sc.num_tiles, P))
    e, ok, rep = compare_bwd(torch, SK.composite_bwd(a1, g1, g2, *geo_s),
                             SK.composite_bwd_ref(a1, g1, g2, *geo_s),
                             COMPOSITE_GROUPS, ZERO_LANES["composite"], a1[..., 9] < 0.5)
    errs["composite_bwd"].append(e)
    log(f"# kernels/random: composite_bwd {tuple(a1.shape)} "
        + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("composite_bwd vs twin (random)")
    a3 = torch.as_tensor(shade_tie_attrs(rng, mc.num_tiles, mc.max_per_tile,
                                         mc.tiles_x, mc.tile_w), device=dev)
    g3, g4 = (torch.as_tensor(x, device=dev) for x in cotangents(rng, mc.num_tiles, P))
    e, ok, rep = compare_bwd(torch, MK.shade_bwd(a3, g3, g4, *geo_m, mc.sigma),
                             MK.shade_bwd_ref(a3, g3, g4, *geo_m, mc.sigma),
                             SHADE_GROUPS, ZERO_LANES["shade"], a3[..., 9] < 0.5)
    errs["shade_bwd"].append(e)
    log(f"# kernels/random: shade_bwd {tuple(a3.shape)} with built ties "
        + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
        + f" {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("shade_bwd vs twin (random, ties)")
    # kernels 5 and 6 (the fused trunk) at the step's row counts, din 93
    from dgmesh_torch.ops import mlp_fused as MF
    errs["trunk_fwd"], errs["trunk_bwd"] = [], []
    _, wb, bp = random_trunk(torch, MLP_DIN, dev, seed=0)
    for n in MLP_ROWS:
        x = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, MLP_DIN)).astype(np.float32), device=dev)
        g = torch.as_tensor(rng.normal(size=(n, 256)).astype(np.float32), device=dev)
        ok, rep = compare_trunk(torch, MF, x, wb, bp, g)
        errs["trunk_fwd"].append(rep["out"][2])
        errs["trunk_bwd"].append(max(rep[k][2] for k in ("dx", "dW", "db")))
        log(f"# kernels/random: trunk_fwd/trunk_bwd ({n},{MLP_DIN}): {trunk_report(rep)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trunk kernels vs twins (random, {n} rows)")
        if KERNELS_ONLY:
            for name, fk in (("trunk_fwd", lambda: MF.trunk_fwd(x, wb, bp)),
                             ("trunk_bwd", lambda: MF.trunk_bwd(x, wb, bp, g))):
                log(f"# timing/random {name} ({n} rows): "
                    f"{time_cuda(torch, fk, 5):.4f} ms/launch")
        del x, g
    if KERNELS_ONLY:
        for name, fk in (("composite_bwd", lambda: SK.composite_bwd(a1, g1, g2, *geo_s)),
                         ("shade_bwd", lambda: MK.shade_bwd(a3, g3, g4, *geo_m, mc.sigma))):
            log(f"# timing/random {name}: {time_cuda(torch, fk, 5):.4f} ms/launch")
        if failures:
            print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
            return 1
        log("# --kernels-only: stopping after the kernel checks; no result line")
        return 0
    del a1, a2, a3, g1, g2, g3, g4

    # 4. render --------------------------------------------------------------
    t0 = time.perf_counter()
    state = build_shell_state(torch, cfg, N_GAUSS, dev)
    batches = view_batches(W, H, N_VIEWS, dev)
    torch.cuda.synchronize()
    log(f"# state: {int(state.gs.alive.sum())} live Gaussians of {t.max_gaussians}, "
        f"grid {cfg.model.grid_res}, {W}x{H}, K {t.max_gaussians_per_tile}/"
        f"{t.max_faces_per_tile}, built in {time.perf_counter() - t0:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    SK.composite_tiles.launches = 0
    MK.shade_tiles.launches = 0
    renders = 0
    for i, b in enumerate(batches):
        times = []
        for r in range(1 + REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, aux = render_frame_with_aux(ctx, state, b, cfg.model.sh_degree)
            torch.cuda.synchronize()
            renders += 1
            if r:
                times.append((time.perf_counter() - t0) * 1e3)
        finite = all(bool(torch.isfinite(out[k]).all())
                     for k in ("render", "mesh_image", "mask", "verts", "vtx_color"))
        shapes_ok = (tuple(out["render"].shape) == (3, H, W)
                     and tuple(out["mesh_image"].shape) == (3, H, W)
                     and tuple(out["mask"].shape) == (H, W))
        ovf = {k: int(v) for k, v in aux.items()}
        V, F = int(out["n_verts"]), int(out["n_faces"])
        log(f"# view {i} fid {float(b.fid):.3f}: {statistics.median(times):.2f} ms median of "
            f"{REPEATS} ({', '.join(f'{x:.2f}' for x in times)}); V {V} F {F}; "
            f"overflow splat {ovf['splat_overflow']} dup {ovf['splat_dup_overflow']} "
            f"mesh {ovf['mesh_overflow']} raster {ovf['raster_overflow']}; "
            f"finite {finite}; mean gs {float(out['render'].mean()):.5f} "
            f"mesh {float(out['mesh_image'].mean()):.5f} mask {float(out['mask'].mean()):.5f}")
        if not (finite and shapes_ok):
            failures.append(f"view {i}: non-finite or misshapen output")
        if ovf["mesh_overflow"] != 0:
            failures.append(f"view {i}: mesh_overflow {ovf['mesh_overflow']} != 0")
        if V == 0 or F == 0:
            failures.append(f"view {i}: empty mesh")
    launches = {"composite_tiles": SK.composite_tiles.launches,
                "shade_tiles": MK.shade_tiles.launches}
    log(f"# renders {renders}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for k, n in launches.items():
        if n < renders:
            failures.append(f"{k}: {n} launches in {renders} renders")

    # 4b. view 0 again through render_frame, each function it calls wrapped
    #     to time it (where the time goes) and to keep the kernels' inputs;
    #     the kernels are then held against their twins on those real rows,
    #     and timed ----------------------------------------------------------
    targets = [  # what render_frame calls, in order
        (testing, "_deform_all", "deform_mlps"),
        (splat, "preprocess", "splat_preprocess"),
        (splat, "bin_gaussians", "splat_binning"),
        (splat, "tile_attrs", "splat_tile_rows"),
        (SK, "composite_tiles", "composite_kernel"),
        (ctx, "dpsr", "dpsr"),
        (step, "marching_tets", "marching_tets"),
        (testing, "_mesh_colors", "mesh_color_mlps"),
        (MR, "rasterize", "mesh_binning"),
        (MR, "tile_attrs", "mesh_tile_rows"),
        (MK, "shade_tiles", "shade_kernel"),
    ]
    with torch.no_grad():
        stages, total, args = call_by_stage(
            torch, targets,
            lambda: render_frame_with_aux(ctx, state, batches[0], cfg.model.sh_degree),
            REPEATS)
    log(f"# stages of view 0 (ms, median of {REPEATS}, host clock around synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.2f}; whole call {total:.2f}, of it outside "
        f"the stages {total - sum(stages.values()):.2f}")
    # float32 MLP work: 2 * rows * sum(din * dout) over each net's layers
    nets = state.nets
    rows_d = args["deform_mlps"][1].shape[0]
    rows_c = int(args["mesh_color_mlps"][2].sum())
    for stage, rows, pair in (("deform_mlps", rows_d, (nets.deform, nets.deform_normal)),
                              ("mesh_color_mlps", rows_c, (nets.deform_back, nets.appearance))):
        flop = 2 * rows * sum(m.in_features * m.out_features for net in pair
                              for m in net.modules() if isinstance(m, torch.nn.Linear))
        log(f"# {stage}: {rows} rows, {flop / 1e9:.2f} GFLOP, "
            f"{flop / stages[stage] / 1e9:.2f} TFLOP/s over the stage's time")
    ra1, ra2 = args["composite_kernel"][0], args["shade_kernel"][0]
    if args["composite_kernel"][1:] != geo_s or args["shade_kernel"][1:] != geo_m + (mc.sigma,):
        failures.append("kernels called with another geometry than the config's")
    e, ok = compare_composite(torch, SK, ra1, geo_s)
    errs["composite_tiles"].append(e)
    log(f"# kernels/view0: composite_tiles {tuple(ra1.shape)} max_abs_err {e:.3g} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("composite_tiles vs twin (view 0)")
    e, ok, nf = compare_shade(torch, MK, ra2, geo_m, mc.sigma)
    errs["shade_tiles"].append(e)
    log(f"# kernels/view0: shade_tiles {tuple(ra2.shape)} max_abs_err {e:.3g} "
        f"({nf} fid mismatches) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("shade_tiles vs twin (view 0)")

    P = sc.tile_h * sc.tile_w
    T1, K1 = ra1.shape[:2]
    T2, K2 = ra2.shape[:2]
    v1, n_pass, _ = composite_pairs(torch, SK, ra1, sc)
    v2 = int((ra2[..., 9] > 0.5).sum()) * P
    kernel_rows = {  # name: (kernel call, twin call, bytes, operations) at real rows
        "composite_tiles": (lambda: SK.composite_tiles(ra1, *geo_s),
                            lambda: SK.composite_tiles_ref(ra1, *geo_s),
                            T1 * K1 * 16 * 4 + T1 * P * 4 * 4,
                            v1 * COMPOSITE_TEST_OPS + n_pass * COMPOSITE_ACCUM_OPS),
        "shade_tiles": (lambda: MK.shade_tiles(ra2, *geo_m, mc.sigma),
                        lambda: MK.shade_tiles_ref(ra2, *geo_m, mc.sigma),
                        T2 * K2 * 24 * 4 + T2 * P * 6 * 4, v2 * SHADE_OPS),
    }
    log(f"# view 0 rows: {v1 // P} valid composite rows of {T1 * K1}, {n_pass} passing "
        f"(pixel, row) pairs; {v2 // P} valid shade rows of {T2 * K2}")
    kernels = []
    del args, state

    # 4c. the YAML's own gaussian_ratio and init_density_threshold: one render
    #     of view 0, reported and not held to the caps ---------------------
    ycfg = load_cfg(bench_values=False)
    ystate = build_shell_state(torch, ycfg, N_GAUSS, dev)
    ctx_y = StepContext(ycfg, W, H, device=dev)
    out, aux = render_frame_with_aux(ctx_y, ystate, batches[0], ycfg.model.sh_degree)
    torch.cuda.synchronize()
    ovf = {k: int(v) for k, v in aux.items()}
    log(f"# YAML's own values (gaussian_ratio {ycfg.model.gaussian_ratio}, "
        f"init_density_threshold {ycfg.optimization.init_density_threshold}), view 0: "
        f"V {int(out['n_verts'])}/{ycfg.tpu.max_verts} "
        f"F {int(out['n_faces'])}/{ycfg.tpu.max_faces}")
    log(f"#   overflow splat {ovf['splat_overflow']} dup {ovf['splat_dup_overflow']} "
        f"mesh {ovf['mesh_overflow']} raster {ovf['raster_overflow']}; finite "
        f"{all(bool(torch.isfinite(out[k]).all()) for k in ('render', 'mesh_image'))}")
    del out, ystate

    # 5. train: the mesh-phase training step at full width, 1 warm-up and
    #    TRAIN_STEPS timed steps, each from the same frozen state; the launch
    #    counters zeroed just before and read just after -------------------
    tstate = build_shell_state(torch, cfg, N_GAUSS, dev)
    tbatch = bench_batch(W, H, dev)
    flags = train_flags(step, cfg.model.sh_degree)
    counters = (SK.composite_tiles, SK.composite_bwd, MK.shade_tiles, MK.shade_bwd)
    med, peak, launches = train_run(torch, step, ctx, tstate, tbatch, flags, counters,
                                    failures)
    for k, n in launches.items():
        if n < 1 + TRAIN_STEPS:
            failures.append(f"{k}: {n} launches in {1 + TRAIN_STEPS} training steps")
    summary = {"f32": (med, peak)}

    # 5b. where a step's time goes (forward / backward / optimizer, each
    #     between two synchronisations), and the backward kernels' real rows
    #     and cotangents, held against their twins and timed -------------
    targets = [(step, "loss_and_aux", "forward"), (step, "backward", "backward"),
               (step, "apply_updates", "optimizer"),
               (SK, "composite_bwd", "composite_bwd_kernel"),
               (MK, "shade_bwd", "shade_bwd_kernel")]
    stages, total, args = call_by_stage(
        torch, targets, lambda: step.train_step(ctx, tstate, tbatch, flags), 2,
        what="train_step")
    log("# train stages (ms, median of 2, host clock around synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items() if "kernel" not in k)
        + f"; whole step {total:.2f}, of it outside them "
        f"{total - stages['forward'] - stages['backward'] - stages['optimizer']:.2f}; "
        f"inside backward: composite_bwd {stages['composite_bwd_kernel']:.3f}, "
        f"shade_bwd {stages['shade_bwd_kernel']:.3f}")
    # the step's cotangents are ~1e-6, below the tolerance's absolute floor;
    # the backward is linear in them, so each is scaled to a largest |value|
    # of 1 (zeros stay zeros) before the kernels and the twins see them
    ca = args["composite_bwd_kernel"][0].detach()
    sa = args["shade_bwd_kernel"][0].detach()
    cg, cga, sg, sgs = (x.detach() / x.detach().abs().max().clamp_min(1e-30)
                        for x in (*args["composite_bwd_kernel"][1:3],
                                  *args["shade_bwd_kernel"][1:3]))
    log("# train rows' cotangents, largest |value| before scaling to 1: "
        + ", ".join(f"{n} {float(x.detach().abs().max()):.3g}" for n, x in (
            ("composite g_rgb", args["composite_bwd_kernel"][1]),
            ("g_alpha", args["composite_bwd_kernel"][2]),
            ("shade g_rgb", args["shade_bwd_kernel"][1]),
            ("g_soft", args["shade_bwd_kernel"][2]))))
    if (args["composite_bwd_kernel"][3:] != geo_s
            or args["shade_bwd_kernel"][3:] != geo_m + (mc.sigma,)):
        failures.append("backward kernels called with another geometry than the config's")
    for name, got, want, groups, zl, inv in (
            ("composite_bwd", SK.composite_bwd(ca, cg, cga, *geo_s),
             SK.composite_bwd_ref(ca, cg, cga, *geo_s), COMPOSITE_GROUPS,
             ZERO_LANES["composite"], ca[..., 9] < 0.5),
            ("shade_bwd", MK.shade_bwd(sa, sg, sgs, *geo_m, mc.sigma),
             MK.shade_bwd_ref(sa, sg, sgs, *geo_m, mc.sigma), SHADE_GROUPS,
             ZERO_LANES["shade"], sa[..., 9] < 0.5)):
        e, ok, rep = compare_bwd(torch, got, want, groups, zl, inv)
        errs[name].append(e)
        log(f"# kernels/train: {name} {tuple(got.shape)} "
            + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} vs twin (training rows)")
        del got, want
    c_valid, c_pass, c_live = composite_pairs(torch, SK, ca, sc)
    s_valid, s_soft, s_rgb = shade_pairs(torch, SK, sa, sg, sgs, mc)
    log(f"# train rows: composite {c_valid} valid (pixel, row) pairs, {c_pass} passing, "
        f"{c_live} below the clamp; shade {s_valid} valid pairs, {s_soft} with a soft "
        f"gradient, {s_rgb} winner pixels with a colour gradient")
    kernel_rows["composite_bwd"] = (
        lambda: SK.composite_bwd(ca, cg, cga, *geo_s),
        lambda: SK.composite_bwd_ref(ca, cg, cga, *geo_s),
        2 * ca.numel() * 4 + cg.numel() * 4 + cga.numel() * 4,
        c_valid * COMPOSITE_TEST_OPS + c_pass * COMPOSITE_BWD_PASS_OPS
        + c_live * COMPOSITE_BWD_LIVE_OPS)
    kernel_rows["shade_bwd"] = (
        lambda: MK.shade_bwd(sa, sg, sgs, *geo_m, mc.sigma),
        lambda: MK.shade_bwd_ref(sa, sg, sgs, *geo_m, mc.sigma),
        2 * sa.numel() * 4 + sg.numel() * 4 + sgs.numel() * 4,
        s_valid * SHADE_OPS + s_soft * SHADE_BWD_SOFT_OPS + s_rgb * SHADE_BWD_RGB_OPS)
    train_launches = launches
    summary["f32"] += (stages,)
    for name, (fk, fp, nbytes, nops) in kernel_rows.items():
        ms = time_cuda(torch, fk, KERNEL_TIMING_LAUNCHES)
        plain_ms = time_cuda(torch, fp, 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=train_launches[name], max_abs_err=max(errs[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None))
        log(f"# timing {name}: {ms:.4f} ms/launch, twin {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G ops); "
            f"no single PyTorch call computes it (library_ms null)")
    del ca, cg, cga, sa, sg, sgs, ra1, ra2, args, kernel_rows

    # 5f. the fused configuration (tpu.mlp_bf16 = tpu.mlp_fused = True) from
    #     the same state and view: every kernel counted, kernels 5 and 6
    #     TRUNKS times a step; the stages; kernels 5 and 6 held against their
    #     twins on every trunk call of a step, then timed on the largest one
    #     beside their bound and the cuBLAS chain of the "bf16" mode --------
    fcfg = load_cfg()
    fcfg.tpu.mlp_bf16 = fcfg.tpu.mlp_fused = True
    ctx_f = StepContext(fcfg, W, H, device=dev)
    trunk_counters = (MF.trunk_fwd, MF.trunk_bwd)
    med, peak, launches = train_run(torch, step, ctx_f, tstate, tbatch, flags,
                                    counters + trunk_counters, failures, " fused")
    for k, n in launches.items():
        if n < 1 + TRAIN_STEPS:
            failures.append(f"fused: {k}: {n} launches in {1 + TRAIN_STEPS} training steps")
    for c in trunk_counters:
        if launches[c.__name__] != TRUNKS * (1 + TRAIN_STEPS):
            failures.append(f"fused: {c.__name__}: {launches[c.__name__]} launches, not "
                            f"{TRUNKS} in each of {1 + TRAIN_STEPS} training steps")
    targets = [(step, "loss_and_aux", "forward"), (step, "backward", "backward"),
               (step, "apply_updates", "optimizer"),
               (MF, "trunk_fwd", "trunk_fwd_kernel"), (MF, "trunk_bwd", "trunk_bwd_kernel")]
    calls = {}
    stages, total, _ = call_by_stage(
        torch, targets, lambda: step.train_step(ctx_f, tstate, tbatch, flags), 2,
        what="train_step", per_call={"trunk_fwd_kernel": TRUNKS, "trunk_bwd_kernel": TRUNKS},
        keep=calls)
    log_stages(stages, total, " fused", ("trunk_fwd", "trunk_bwd"))
    summary["fused"] = (med, peak, stages)
    rows = []
    for x, wb, bp, g in calls["trunk_bwd_kernel"]:
        x, g = x.detach(), g.detach()
        gmax = float(g.abs().max())
        # like kernels 2 and 4, each cotangent is scaled to a largest |value| of 1
        ok, rep = compare_trunk(torch, MF, x, wb, bp, g / max(gmax, 1e-30))
        errs["trunk_fwd"].append(rep["out"][2])
        errs["trunk_bwd"].append(max(rep[k][2] for k in ("dx", "dW", "db")))
        log(f"# kernels/train: trunk_fwd/trunk_bwd {tuple(x.shape)}, |g| max {gmax:.3g} "
            f"scaled to 1: {trunk_report(rep)} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trunk kernels vs twins (training rows, {x.shape[0]})")
        rows.append((x, wb, bp, g / max(gmax, 1e-30)))
    x, wb, bp, g = max(rows, key=lambda r: r[0].shape[0])
    n, din = x.shape
    chain = trunk_from_pack(torch, wb, bp, din)
    xg = x.clone().requires_grad_(True)
    out = chain(xg, "bf16")
    params = [xg] + list(chain.parameters())
    fwd_flops = 2 * n * (7 * 256 * 256 + 2 * din * 256)
    w_bytes = wb.numel() * 2 + bp.numel() * 4
    trunk_rows = {  # name: (kernel, twin, cuBLAS chain, bytes, operations)
        "trunk_fwd": (lambda: MF.trunk_fwd(x, wb, bp), lambda: MF.trunk_fwd_ref(x, wb, bp),
                      lambda: chain(x, "bf16"), n * din * 4 + n * 256 * 4 + w_bytes, fwd_flops),
        "trunk_bwd": (lambda: MF.trunk_bwd(x, wb, bp, g), lambda: MF.trunk_bwd_ref(x, wb, bp, g),
                      lambda: torch.autograd.grad(out, params, g, retain_graph=True),
                      2 * n * din * 4 + n * 256 * 4 + w_bytes + 9 * 256 * 256 * 4 + 8 * 256 * 4,
                      3 * fwd_flops),
    }
    for name, (fk, fp, fl, nbytes, nops) in trunk_rows.items():
        with torch.no_grad() if name == "trunk_fwd" else contextlib.nullcontext():
            ms = time_cuda(torch, fk, KERNEL_TIMING_LAUNCHES)
            plain_ms = time_cuda(torch, fp, 2)
            library_ms = time_cuda(torch, fl, KERNEL_TIMING_LAUNCHES)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_BF16_TC * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[name], max_abs_err=max(errs[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms))
        log(f"# timing {name} ({n},{din}): {ms:.4f} ms/launch, twin {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {nops / 1e12:.3f} TFLOP, "
            f"{nops / ms / 1e9:.1f} TFLOP/s); library: the bf16 mode's chain of nine cuBLAS "
            f"GEMMs + bias + ReLU{' (autograd backward)' if name == 'trunk_bwd' else ''} "
            f"{library_ms:.4f} ms")
    del rows, calls, x, g, xg, out, params, chain, trunk_rows

    # 5g. the bf16 configuration (tpu.mlp_bf16, not fused; bench.py's own
    #     precision): the same state, view and checks, reported -----------
    bcfg = load_cfg()
    bcfg.tpu.mlp_bf16 = True
    ctx_b = StepContext(bcfg, W, H, device=dev)
    med, peak, launches = train_run(torch, step, ctx_b, tstate, tbatch, flags, counters,
                                    failures, " bf16")
    targets = [(step, "loss_and_aux", "forward"), (step, "backward", "backward"),
               (step, "apply_updates", "optimizer")]
    stages, total, _ = call_by_stage(
        torch, targets, lambda: step.train_step(ctx_b, tstate, tbatch, flags), 2,
        what="train_step")
    log_stages(stages, total, " bf16", ())
    summary["bf16"] = (med, peak, stages)
    log("# steps side by side (ms/step median; forward / backward / optimizer ms; peak GiB): "
        + "; ".join(f"{k} {v[0]:.2f} ({v[2]['forward']:.1f} / {v[2]['backward']:.1f} / "
                    f"{v[2]['optimizer']:.1f}; {v[1]:.3f})" for k, v in summary.items()))
    del tstate

    # 6. the same path on the card and on the CPU at a small size ------------
    small = _small_cfg(Config)
    ctx_g = StepContext(small, 64, 64, device=dev)
    ctx_c = StepContext(small, 64, 64, device="cpu")
    st_c = build_shell_state(torch, small, 256, "cpu")
    from dgmesh_torch.train.state import state_to
    st_g = state_to(st_c, dev)
    for i, (bg_, bc_) in enumerate(zip(view_batches(64, 64, 2, dev),
                                       view_batches(64, 64, 2, "cpu"))):
        og, ag = render_frame_with_aux(ctx_g, st_g, bg_, small.model.sh_degree)
        oc, ac = render_frame_with_aux(ctx_c, st_c, bc_, small.model.sh_degree)
        d_img = max(float((og[k].cpu() - oc[k]).abs().max())
                    for k in ("render", "mesh_image", "mask"))
        same = (int(og["n_verts"]) == int(oc["n_verts"])
                and int(og["n_faces"]) == int(oc["n_faces"]))
        whole = int(ag["mesh_overflow"]) == 0 and int(ac["mesh_overflow"]) == 0
        ok = same and whole and d_img <= TOL_SMALL and int(oc["n_verts"]) > 0
        log(f"# small view {i}: card vs CPU max image diff {d_img:.3g} (tol {TOL_SMALL}); "
            f"V {int(og['n_verts'])}/{int(oc['n_verts'])} F {int(og['n_faces'])}/"
            f"{int(oc['n_faces'])} of {small.tpu.max_verts}/{small.tpu.max_faces}; "
            f"mesh overflow {int(ag['mesh_overflow'])}/{int(ac['mesh_overflow'])} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"small view {i}: card and CPU disagree")

    # the training step on the card and on the CPU at the small size, from
    # SMALL_SEEDS states; then the same in the fused configuration, from
    # SMALL_SEEDS_FUSED states
    small_train_check(torch, step, small, dev, failures, TOL_SMALL_GP, TOL_SMALL_HEAD,
                      TOL_SMALL_NET, "", SMALL_SEEDS)
    fsmall = _small_cfg(Config)
    fsmall.tpu.mlp_bf16 = fsmall.tpu.mlp_fused = True
    small_train_check(torch, step, fsmall, dev, failures, TOL_SMALL_GP_FUSED,
                      TOL_SMALL_HEAD_FUSED, TOL_SMALL_NET_FUSED, " fused", SMALL_SEEDS_FUSED)

    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def small_train_check(torch, step, small, dev, failures, tol_gp, tol_head, tol_net, label,
                      seeds):
    """The training step on the card and on the CPU (the plain twins) at the
    small size, from each of ``seeds`` states, held to the loss,
    Gaussian-gradient, appearance-head and net-leaf tolerances."""
    from dgmesh_torch.train.state import state_to
    from dgmesh_torch.train.step import StepContext

    ctx_g = StepContext(small, 64, 64, device=dev)
    ctx_c = StepContext(small, 64, 64, device="cpu")
    sflags = train_flags(step, small.model.sh_degree)
    loss_keys = ("loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss",
                 "img_loss")

    def leaf_err(a, b):
        return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def leaf_norm_err(a, b):
        return float((a.cpu() - b).norm()) / max(float(b.norm()), 1e-30)

    worst = dict(loss=0.0, gp=0.0, head=0.0, net=0.0)
    for seed in range(seeds):
        st_c = build_shell_state(torch, small, 256, "cpu", seed=seed)
        st_g = state_to(st_c, dev)
        res = {}
        for where, c, st, b in (("card", ctx_g, st_g, bench_batch(64, 64, dev)),
                                ("cpu", ctx_c, st_c, bench_batch(64, 64, "cpu"))):
            _, m = step.train_step(c, st, b, sflags)
            res[where] = (m, step.loss_and_grads(c, st, b, sflags)[2])
        (m_g, gr_g), (m_c, gr_c) = res["card"], res["cpu"]
        d_loss = max(abs(float(m_g[k]) - float(m_c[k])) / max(abs(float(m_c[k])), 1e-20)
                     for k in loss_keys)
        d_gp = max(leaf_err(a, b) for a, b in zip(gr_g.gp, gr_c.gp))
        # the appearance net's output head takes kernel 4's colour gradient
        # through the vertex scatter and no ReLU: a unit that takes the other
        # side of its kink on the card reaches every other leaf (the deform
        # nets' through the appearance net's input gradient), not this one
        leaves = {nm: [(k.startswith("head_"), a, b) for (k, _), a, b in zip(
            net.named_parameters(), na, nb)]
            for nm, net, na, nb in zip(type(st_c.nets)._fields, st_c.nets, gr_g.nets, gr_c.nets)}
        head_by_net = {nm: max((leaf_err(a, b) for h, a, b in ls if h), default=0.0)
                       for nm, ls in leaves.items()}
        net_by_net = {nm: max(leaf_norm_err(a, b) for h, a, b in ls
                              if not (h and nm == "appearance"))
                      for nm, ls in leaves.items()}
        d_head, d_net = head_by_net["appearance"], max(net_by_net.values())
        for k, v in (("loss", d_loss), ("gp", d_gp), ("head", d_head), ("net", d_net)):
            worst[k] = max(worst[k], v)
        log(f"#   seed {seed}, per net: heads max rel "
            + ", ".join(f"{nm} {v:.3g}" for nm, v in head_by_net.items())
            + "; other leaves norm rel "
            + ", ".join(f"{nm} {v:.3g}" for nm, v in net_by_net.items()))
        same = all(int(m_g[k]) == int(m_c[k]) for k in ("mesh_n_verts", "mesh_n_faces",
                                                         "mesh_overflow",
                                                         "nonfinite_grad_leaves"))
        ok = (same and d_loss <= TOL_SMALL_LOSS and d_gp <= tol_gp
              and d_head <= tol_head and d_net <= tol_net
              and not step_problems(torch, m_g) and not step_problems(torch, m_c))
        log(f"# small{label} train step, seed {seed}: card vs CPU loss terms rel {d_loss:.3g}; "
            f"Gaussian grads rel {d_gp:.3g}; appearance head grads rel {d_head:.3g}; other "
            f"net grads norm rel {d_net:.3g}; V {int(m_g['mesh_n_verts'])}/"
            f"{int(m_c['mesh_n_verts'])} F {int(m_g['mesh_n_faces'])}/"
            f"{int(m_c['mesh_n_faces'])} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"small{label} train step, seed {seed}: card and CPU disagree")
    log(f"# small{label} train step, worst of {seeds} seeds: loss terms "
        f"{worst['loss']:.3g} (tol {TOL_SMALL_LOSS}), Gaussian grads {worst['gp']:.3g} "
        f"(tol {tol_gp}), appearance head {worst['head']:.3g} (tol {tol_head}), "
        f"other net leaves {worst['net']:.3g} (tol {tol_net})")


def train_run(torch, step, ctx, state, batch, flags, counters, failures, label=""):
    """1 warm-up and TRAIN_STEPS timed training steps, each from the same
    frozen state and checked, with the launch counters zeroed just before
    and read just after.  Logs and returns (median ms/step, peak GiB,
    {counter: launches})."""
    W, H = ctx.splat_cfg.width, ctx.splat_cfg.height
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    step_ms = []
    for i in range(1 + TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step.train_step(ctx, state, batch, flags)
        torch.cuda.synchronize()
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
        bad = step_problems(torch, m)
        if bad:
            failures.append(f"{label.strip()}{' ' if label else ''}train step {i}: "
                            + ", ".join(bad))
    launches = {c.__name__: c.launches for c in counters}
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(step_ms)
    log(f"# train{label}: {1 + TRAIN_STEPS} steps at {W}x{H}, grid {ctx.cfg.model.grid_res}, "
        f"{int(state.gs.alive.sum())} live Gaussians, nets {ctx.mlp_mode}; "
        f"V {int(m['mesh_n_verts'])} "
        f"F {int(m['mesh_n_faces'])}; overflow mesh {int(m['mesh_overflow'])} splat "
        f"{int(m['splat_overflow'])} dup {int(m['splat_dup_overflow'])} raster "
        f"{int(m['raster_overflow'])}; nonfinite_grad_leaves {int(m['nonfinite_grad_leaves'])}")
    log("#   losses: " + ", ".join(f"{k} {float(m[k]):.6g}" for k in (
        "loss", "cycle_loss", "mask_loss", "mesh_img_loss", "laplacian_loss", "img_loss",
        "img_psnr", "mesh_psnr")))
    log(f"#   ms/step median of {TRAIN_STEPS}: {med:.2f} ({', '.join(f'{x:.2f}' for x in step_ms)}); "
        f"{1e3 / med:.3f} steps/s; peak memory {peak:.3f} GiB; launches {launches}")
    return med, peak, launches


def log_stages(stages, total, label, kernels):
    """One line: a step's forward / backward / optimizer ms and the named
    kernels' ms per step (host clock around synchronize)."""
    log(f"# train{label} stages (ms, median of 2, host clock around synchronize): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items() if "kernel" not in k)
        + f"; whole step {total:.2f}, of it outside them "
        f"{total - stages['forward'] - stages['backward'] - stages['optimizer']:.2f}"
        + "".join(f"; {k} per step {stages[k + '_kernel']:.3f}" for k in kernels))


def trunk_from_pack(torch, wb, bp, din):
    """An MLPTrunk holding the packed trunk's weights (bf16 values, float32
    parameters): the library yardstick of kernels 5 and 6 runs its "bf16"
    mode on them."""
    from dgmesh_torch.models.mlp import MLPTrunk
    from dgmesh_torch.ops.mlp_fused import DEPTH, SKIP
    trunk = MLPTrunk(din, device=wb.device)
    w = wb.float()
    with torch.no_grad():
        for i, layer in enumerate(trunk.layers):
            k = w[i][:din] if i == 0 else w[i]
            if i == SKIP + 1:
                k = torch.cat([w[DEPTH][:din], w[i]], 0)
            layer.weight.copy_(k.t())
            layer.bias.copy_(bp[i])
    return trunk


def profile_train(torch, cfg, dev) -> int:
    """``--profile``: for the float32 and then the fused configuration, one
    warm-up and one profiled full-width training step (torch.profiler, CPU
    and CUDA activities).  Prints the operators with the most device time,
    then those with the most host time.  No result line."""
    from dgmesh_torch.train import step
    from dgmesh_torch.train.step import StepContext

    st = build_shell_state(torch, cfg, N_GAUSS, dev)
    b = bench_batch(IMG, IMG, dev)
    flags = train_flags(step, cfg.model.sh_degree)
    fcfg = load_cfg()
    fcfg.tpu.mlp_bf16 = fcfg.tpu.mlp_fused = True
    for c in (cfg, fcfg):
        ctx = StepContext(c, IMG, IMG, device=dev)
        step.train_step(ctx, st, b, flags)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step.train_step(ctx, st, b, flags)
            torch.cuda.synchronize()
        ka = prof.key_averages()
        log(f"# --profile: nets {ctx.mlp_mode}")
        log(ka.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=60))
        log(ka.table(sort_by="self_cpu_time_total", row_limit=20, max_name_column_width=60))
    log("# --profile: stopping after the profiles; no result line")
    return 0


def load_cfg(bench_values: bool = True):
    """configs/synthetic-quality-288.yaml through the port's config.  With
    ``bench_values``, bench.py's values for the two fields its state takes
    from Config()'s defaults instead of the YAML's (gaussian_ratio 1.5, not
    1.2; init_density_threshold 0.05, not 0.0), as bench.py measures it."""
    import argparse
    from dgmesh_torch.config import config_from_args
    cfg = config_from_args(argparse.Namespace(), CONFIG)
    if bench_values:
        cfg.model.gaussian_ratio = 1.5
        cfg.optimization.init_density_threshold = 0.05
    return cfg


def _small_cfg(Config):
    """The test fixture's miniature shapes (grid 32, 512 Gaussian slots, 64²)
    with its ROOMY caps, which hold the whole 256-point shell's mesh."""
    cfg = Config()
    cfg.model.is_blender = True
    cfg.model.grid_res = 32
    cfg.model.sh_degree = 1
    cfg.optimization.dpsr_sig = 2.0
    t = cfg.tpu
    t.max_gaussians = 512
    t.max_verts, t.max_faces = 16384, 32768
    t.max_gaussians_per_tile, t.max_dup = 64, 1 << 12
    t.max_faces_per_tile, t.max_face_dup = 1024, 1 << 16
    t.mr_cull_backface = True
    return cfg


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
