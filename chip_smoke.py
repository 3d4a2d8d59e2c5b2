#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dgmesh_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one GPU

Phases; any failure exits non-zero and prints no result:
  1. card     — the card's name and power limit (nvidia-smi);
  2. build    — nvcc builds every kernel of the render path from
                dgmesh_torch/csrc (one nvcc per source, in parallel);
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the main path's full-width shapes, on seeded random rows with
                the edge cases (invalid rows, alpha-clamped rows, slivers
                below AREA_MIN, back faces, exact z ties);
  4. render   — configs/synthetic-quality-288.yaml with bench.py's shell
                state (100k Gaussians, radius 0.45, seed 0) and seeded random
                nets: render_frame for 4 orbit views at 800², grid 288, with
                the launch counters zeroed just before and read just after;
                then render_frame on the first view again with each function
                it calls wrapped to time it (where the time goes) and to keep
                the kernels' inputs, on which the kernels are held against
                their twins again and timed; then one render at the YAML's own
                gaussian_ratio and init_density_threshold, reported only;
  5. check    — the same path on the card and on the CPU (the plain twins)
                at a small size with room in the mesh caps must agree;
  6. result   — one JSON line of per-kernel numbers, then the last line
                {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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

# Float32 operations per (pixel, row) pair, counted from the kernels' source
# (an exp, log1p, sqrt or division counts as one operation):
COMPOSITE_TEST_OPS = 16     # every valid row: power, exp, clamp, the tests
COMPOSITE_ACCUM_OPS = 11    # rows that pass the tests: log1p, exp, rgb sums
SHADE_OPS = 118             # every valid row: edges, barycentrics, z, soft

DEVICE = "cuda"
IMG = 800             # 800x800 views, 16x16 tiles: T = 2500
N_GAUSS = 100_000     # live Gaussians in the config's 131,072 slots
N_VIEWS = 4
REPEATS = 3
KERNEL_TIMING_LAUNCHES = 20
TOL_COMPOSITE = 1e-4  # rgb/alpha: sequential vs cumsum/einsum summation order
TOL_SHADE = 1e-5      # rgb/soft; hard and fid must agree exactly
TOL_SMALL = 1e-4      # card vs CPU at the small size: images


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


def render_by_stage(torch, targets, render, repeats):
    """Call ``render`` ``repeats`` times with each ``(owner, attribute, stage)``
    of ``targets`` replaced by a wrapper that times its call between two
    synchronisations and keeps its arguments; the originals are put back
    after.  Returns ({stage: median ms}, median ms of the whole call,
    {stage: arguments of its last call}).  A stage that is not called once
    per render fails: the targets no longer match what the render calls."""
    times = {stage: [] for _, _, stage in targets}
    args = {}
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

    def timed(stage, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            torch.cuda.synchronize()
            times[stage].append((time.perf_counter() - t0) * 1e3)
            args[stage] = a
            return res
        return wrapper

    totals = []
    try:
        for (owner, attr, fn), (_, _, stage) in zip(saved, targets):
            setattr(owner, attr, timed(stage, fn))
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render()
            torch.cuda.synchronize()
            totals.append((time.perf_counter() - t0) * 1e3)
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    missing = [k for k, ts in times.items() if len(ts) != repeats]
    if missing:
        raise RuntimeError(f"render_frame did not call {missing} once per render")
    return ({k: statistics.median(ts) for k, ts in times.items()},
            statistics.median(totals), args)


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

    # 3. kernels vs twins on seeded random rows at full width ----------------
    cfg = load_cfg()
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
    del a1, a2

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
        (splat, "composite_tiles", "composite_kernel"),
        (ctx, "dpsr", "dpsr"),
        (step, "marching_tets", "marching_tets"),
        (testing, "_mesh_colors", "mesh_color_mlps"),
        (MR, "rasterize", "mesh_binning"),
        (MR, "tile_attrs", "mesh_tile_rows"),
        (MR, "shade_tiles", "shade_kernel"),
    ]
    with torch.no_grad():
        stages, total, args = render_by_stage(
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
    with torch.no_grad():
        # pairs that pass the composite alpha tests, counted in tile chunks
        n_pass = 0
        px, py = SK.tile_pixels(T1, sc.tiles_x, sc.tile_h, sc.tile_w, 0.0, dev)
        for s in range(0, T1, 100):
            at = ra1[s:s + 100]
            dx = at[..., 0:1] - px[s:s + 100, None]
            dy = at[..., 1:2] - py[s:s + 100, None]
            pw = -0.5 * (at[..., 2:3] * dx * dx + at[..., 4:5] * dy * dy) - at[..., 3:4] * dx * dy
            al = torch.clamp_max(at[..., 5:6] * torch.exp(pw), 0.99)
            n_pass += int(((at[..., 9:10] > 0.5) & (pw <= 0) & (al >= 1 / 255)).sum())
    v1 = int((ra1[..., 9] > 0.5).sum())
    v2 = int((ra2[..., 9] > 0.5).sum())
    kernels = []
    specs = [
        ("composite_tiles", "dgmesh_torch/csrc/composite.cu",
         "dgmesh_tpu/ops/splat_pallas.py:34",
         lambda: SK.composite_tiles(ra1, *geo_s), lambda: SK.composite_tiles_ref(ra1, *geo_s),
         T1 * K1 * 16 * 4 + T1 * P * 4 * 4,
         v1 * P * COMPOSITE_TEST_OPS + n_pass * COMPOSITE_ACCUM_OPS),
        ("shade_tiles", "dgmesh_torch/csrc/shade.cu",
         "dgmesh_tpu/ops/mesh_raster_pallas.py:40",
         lambda: MK.shade_tiles(ra2, *geo_m, mc.sigma),
         lambda: MK.shade_tiles_ref(ra2, *geo_m, mc.sigma),
         T2 * K2 * 24 * 4 + T2 * P * 6 * 4, v2 * P * SHADE_OPS),
    ]
    for name, src, rep, fk, fp, nbytes, nops in specs:
        ms = time_cuda(torch, fk, KERNEL_TIMING_LAUNCHES)
        plain_ms = time_cuda(torch, fp, 2)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / PEAK_F32 * 1e3
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=max(errs[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None))
        log(f"# timing {name}: {ms:.4f} ms/launch, twin {plain_ms:.3f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms ({nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} G ops; "
            f"valid rows {v1 if name == 'composite_tiles' else v2}); "
            f"no single PyTorch call computes it (library_ms null)")
    del ra1, ra2, args, state

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

    # 5. the same path on the card and on the CPU at a small size ------------
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

    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
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
