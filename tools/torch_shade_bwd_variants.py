#!/usr/bin/env python3
"""Time versions of the port's mesh shade backward (kernel 4), of its mesh
shade forward (kernel 3), of its splat compositor (kernels 1 and 2) or of
its fused trunk (kernels 5 and 6), side by side on one NVIDIA GPU.

    python3 tools/torch_shade_bwd_variants.py [--random] SOURCE.cu ...
    python3 tools/torch_shade_bwd_variants.py [--random] SHADE.cu ...
    python3 tools/torch_shade_bwd_variants.py [--random] COMPOSITE_BWD.cu ...
    python3 tools/torch_shade_bwd_variants.py [--random] COMPOSITE.cu[:noS] ...
    python3 tools/torch_shade_bwd_variants.py TRUNK_FWD.cu[:transposed] ...
    python3 tools/torch_shade_bwd_variants.py TRUNK_BWD.cu[:nodin] ...

Versions of the mesh shade forward (kernel 3): each SHADE.cu is a version
of ``dgmesh_torch/csrc/shade.cu`` that exports ``shade_tiles_launch`` with
its C signature.  Each is timed as a render calls it (no residuals) and as
training calls it (with the residuals win and M), in two rounds, the second
in reverse order, on render view 0's rows (chip_smoke.py's phase 4b: the
first orbit view of the state below) and on a float32 training step's rows
(below), or with ``--random`` on chip_smoke.random_shade_attrs's rows.
Printed per source and row set: ms per launch of each call, the error of
rgb and soft against the plain twin (chip_smoke.TOL_SHADE), whether hard,
fid and win are the twin's exactly and M within TOL_SHADE of it relative to
max(1, |M|), whether the call with residuals gives the call without's four
outputs, whether two launches give the same bits, and whether its six
outputs are the first source's bits.

Versions of the splat compositor's forward (kernel 1): each COMPOSITE.cu
exports ``composite_tiles_launch``, with the residual pointer S, or with
the ``:noS`` suffix without it (kernel 1's signature before it wrote S).
Each is timed as a render calls it (no S) and as training calls it (with
S), in two rounds, the second in reverse order, on render view 0's rows
(chip_smoke.py's phase 4b, the rows its kernels line times) and on a
float32 training step's rows (kernel 2's, below), or with ``--random`` on
chip_smoke.py's random composite rows.  Printed per row set: its valid
rows and tiles, the (pixel, valid row) pairs that pass the alpha gate, and
the (warp, valid row) pairs in which some pixel passes, for warps of 8x4
pixels and of two 16-pixel rows, and the 8x4 warps that meet the bounding
box of the row's gate ellipse; then per source: ms per launch of each
call, the error of rgb and alpha against the plain twin
(chip_smoke.TOL_COMPOSITE), whether S is within it of the twin's relative
to max(1, |S|) and asking for S leaves rgb and alpha the same bits, whether
two launches give the same bits, and whether rgb, alpha and S are the
first source's bits.

Versions of the splat compositor's backward: each COMPOSITE_BWD.cu is a
version of ``dgmesh_torch/csrc/composite_bwd.cu`` that exports
``composite_bwd_launch`` with its C signature, or ``composite_bwd_res_launch``
(given the forward's residuals, each pixel's rgb and log-transmittance S,
as the training step calls it; a version with both is timed through it).
The rows are those of kernel 4's versions below, with kernel 2's
arguments: a float32 training step's rows and cotangents (each scaled to a
largest |value| of 1), or with ``--random`` chip_smoke.py's random
composite rows and cotangents.  Printed per source: ms per launch in two
rounds, the error against the plain twin per lane group
(chip_smoke.compare_bwd's limits), whether two launches give the same
bits, and whether its output equals the first source's bit for bit.

Versions of the fused trunk forward: each TRUNK_FWD.cu is a version of
``dgmesh_torch/csrc/mlp_fwd.cu`` that exports ``mlp_fwd_launch`` with its C
signature, given the stage pack (``mlp_fused.stage_pack``), or with the
``:transposed`` suffix the transposed pack (the layout kernel 5 read before
it had a stage pack).  They are timed on seeded random rows at
the fused step's trunk shapes, TRUNK_SHAPES, with chip_smoke.py's random
trunk; printed per source and shape: ms per launch in two rounds, the
error against the plain twin (chip_smoke.py's TOL_MLP_FWD_* measures),
whether two launches give the same bits, and whether its output equals
the first source's bit for bit.

Versions of the fused trunk backward (kernel 6): each TRUNK_BWD.cu is a
version of ``dgmesh_torch/csrc/mlp_bwd.cu`` that exports
``mlp_bwd_rows_launch`` and ``mlp_bwd_wgrad_launch`` with their C
signatures, the weight-gradient pass given mlp_fused's row splits and the
input width, or with the ``:nodin`` suffix 32 row splits and no width (that
pass's signature before its wgmma redesign).
The same rows and trunk as kernel 5's, with a seeded normal cotangent;
printed per shape the time torch.sum takes to read a bf16 tensor of the
workspace's size (the rate a read-only pass reaches), and per source: ms
per call (both passes) and of the
weight-gradient pass with its reductions alone, each in two rounds, dx, dW
and db against the plain twin (chip_smoke.compare_trunk's measures),
whether two calls give the same bits, and whether dx, dW and db are the
first source's bits.  What follows is about kernel 4's versions.

Each SOURCE.cu is a version of ``dgmesh_torch/csrc/shade_bwd.cu`` that
exports ``shade_bwd_launch`` with its C signature (an older version, or one
with a part taken out to see what that part costs); one that also exports
``shade_bwd_res_launch`` is timed through that, given the forward's
residuals, as the training step calls it.  Each is compiled with
the port's nvcc flags (``cuda_build.NVCC_FLAGS``), one nvcc per source, all
at once, into ``build/variants/``.

The rows: one float32 training step of chip_smoke.py's phase 5 (the
synthetic-quality-288 config at 800², bench.py's 100k-Gaussian shell, its
flags and view), with the wrapper's arguments kept and each cotangent
scaled to a largest |value| of 1, as chip_smoke.py does; with ``--random``,
chip_smoke.py's random full-width rows with built ties instead.

Printed per source: ptxas's register, spill and C75xx (serialised wgmma)
lines; then, for kernel 4's versions, ms per launch (CUDA
events over 20 launches after a warm-up), measured in two rounds, the
second in reverse order; the error against the plain twin per lane group
(chip_smoke.compare_bwd's limits); whether two launches give the same bits,
and whether its output equals the first source's bit for bit.  A version that leaves work out disagrees with the twin: that is reported,
not failed.  A version that writes a tail probe (each block's SM id and the
%globaltimer at its start and end in lanes 20-22 of a row of its tile)
also gets a line on how its blocks spread over the SMs and in time
(``tail_report``).  Exits non-zero when there is no GPU or a build fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHES = 20
TRUNK_SHAPES = ((479_974, 93), (131_072, 93))   # (rows, din): mesh vertices, Gaussian slots


def build(sources, out_dir):
    """nvcc each source into a shared library, all at once, with the port's
    headers (``dgmesh_torch/csrc/*.cuh``) on the include path; returns
    {source: (library, ptxas lines)}."""
    from dgmesh_torch.ops import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    headers = b"".join(p.read_bytes() for p in sorted(cuda_build.CSRC.glob("*.cuh")))
    procs = {}
    for src in sources:
        text = open(src, "rb").read() + headers + " ".join(cuda_build.NVCC_FLAGS).encode()
        lib = os.path.join(out_dir, f"lib{os.path.basename(src)[:-3]}-"
                                    f"{hashlib.sha256(text).hexdigest()[:12]}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
               "-o", lib, src]
        procs[src] = (None if os.path.exists(lib) else subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for src, (p, lib) in procs.items():
        log = p.communicate()[0] if p else "built before"
        if p and p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        out[src] = (ctypes.CDLL(lib), [ln.strip() for ln in log.splitlines()
                                       if any(k in ln for k in ("registers", "spill", "C75"))])
    return out


def tile0_args(lib):
    """(0,) for a version whose launchers take the tile offset tile0 (it
    exports ``takes_tile0``), else (): older versions lack the argument."""
    return (0,) if hasattr(lib, "takes_tile0") else ()


def launcher(torch, lib, res):
    """The version's launch on (attrs, g_rgb, g_soft, geometry), through
    its residual entry point with ``res`` where it has one."""
    with_res = hasattr(lib, "shade_bwd_res_launch")
    fn = lib.shade_bwd_res_launch if with_res else lib.shade_bwd_launch
    res = res if with_res else ()
    t0 = tile0_args(lib)
    fn.argtypes = ([ctypes.c_void_p] * (4 + len(res)) + [ctypes.c_int] * (5 + len(t0))
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(attrs, g_rgb, g_soft, tiles_x, tile_h, tile_w, sigma):
        T, K, _ = attrs.shape
        d = torch.empty_like(attrs)
        err = fn(attrs.data_ptr(), g_rgb.data_ptr(), g_soft.data_ptr(),
                 *(x.data_ptr() for x in res), d.data_ptr(), T, K,
                 tiles_x, tile_h, tile_w, *t0, float(sigma),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"shade_bwd_launch failed with cudaError {err}")
        return d
    return run


def timed_rounds(torch, chip_smoke, runs, call):
    """ms per launch of each version, {source: [round 1, round 2]}: call(src)
    launches one version; the second round in reverse order."""
    times = {src: [] for src in runs}
    for order in (list(runs), list(runs)[::-1]):
        for src in order:
            times[src].append(chip_smoke.time_cuda(torch, lambda: call(src), LAUNCHES))
    return times


def trunk_fwd_launcher(torch, lib):
    """The version's kernel 5 on (x, wpackt, bpack) → out (n, 256)."""
    fn = lib.mlp_fwd_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wt, bp):
        out = torch.empty((x.shape[0], 256), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), wt.data_ptr(), bp.data_ptr(), out.data_ptr(), *x.shape,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"mlp_fwd_launch failed with cudaError {err}")
        return out
    return run


def trunk_fwd_main(torch, chip_smoke, libs, transposed, dev) -> int:
    """Kernel 5's versions at TRUNK_SHAPES (module docstring); those in
    ``transposed`` take the transposed pack."""
    from dgmesh_torch.ops import mlp_fused as MF
    runs = {src: trunk_fwd_launcher(torch, lib) for src, (lib, _) in libs.items()}
    rng = np.random.default_rng(0)
    for n, din in TRUNK_SHAPES:
        _, wb, bp = chip_smoke.random_trunk(torch, din, dev, seed=0)
        wt = MF.transpose_pack(wb)
        packs = {src: wt if src in transposed else MF.stage_pack(wt) for src in runs}
        x = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, din)).astype(np.float32), device=dev)
        want = MF.trunk_fwd_ref(x, wb, bp)
        times = timed_rounds(torch, chip_smoke, runs, lambda src: runs[src](x, packs[src], bp))
        first = None
        for src, run in runs.items():
            got, again = run(x, packs[src], bp), run(x, packs[src], bp)
            first = got if first is None else first
            d = got.double() - want.double()
            e_max = float(d.abs().max()) / float(want.abs().max())
            e_norm = float(d.norm()) / float(want.double().norm())
            ok = e_max <= chip_smoke.TOL_MLP_FWD_MAX and e_norm <= chip_smoke.TOL_MLP_FWD_NORM
            print(f"# {src} ({n},{din}): {' / '.join(f'{t:.4f}' for t in times[src])} "
                  f"ms/launch; out max {e_max:.3g} norm {e_norm:.3g} "
                  f"{'agrees' if ok else 'DISAGREES'} with the twin; two launches "
                  f"{'identical' if torch.equal(got, again) else 'DIFFERENT'}; "
                  f"{'the same bits as' if torch.equal(got, first) else 'OTHER bits than'} "
                  f"the first source", flush=True)
        del x, want, got, again, first
    return 0


NODIN_SPLITS = 32   # the row splits of the weight-gradient pass before its redesign


def trunk_bwd_launcher(torch, lib, nodin):
    """The version's kernel 6 on (x, wpack, wpackt, bpack, g): ``run`` →
    (dx, dW, db), both passes; ``run.passes`` → (rows, wgrad, outputs), the
    two passes as functions of no argument on that call's buffers.  With
    ``nodin`` its weight-gradient launcher takes no input width and runs 32
    row splits."""
    from dgmesh_torch.ops import mlp_fused as MF
    rows_fn = lib.mlp_bwd_rows_launch
    rows_fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    wgrad_fn = lib.mlp_bwd_wgrad_launch
    wgrad_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (2 if nodin else 3) + [
        ctypes.c_void_p]
    rows_fn.restype = wgrad_fn.restype = ctypes.c_int

    def check(err):
        if err:
            raise RuntimeError(f"mlp_bwd launch failed with cudaError {err}")

    def passes(x, wb, wt, bp, g):
        n, din = x.shape
        dev = x.device
        dx = torch.empty((n, din), dtype=torch.float32, device=dev)
        dw = torch.empty((MF.DEPTH + 1, 256, 256), dtype=torch.float32, device=dev)
        db = torch.empty((MF.DEPTH, 256), dtype=torch.float32, device=dev)
        ws, db_part, dw_part = MF._bwd_buffers(n, din, dev)
        if nodin:
            dw_part = torch.empty((NODIN_SPLITS, MF.DEPTH + 1, 256, 256),
                                  dtype=torch.float32, device=dev)
        width = () if nodin else (din,)
        stream = torch.cuda.current_stream().cuda_stream
        return (lambda: check(rows_fn(x.data_ptr(), wb.data_ptr(), wt.data_ptr(), bp.data_ptr(),
                                      g.data_ptr(), dx.data_ptr(), ws.data_ptr(),
                                      db_part.data_ptr(), n, din, stream)),
                lambda: check(wgrad_fn(ws.data_ptr(), db_part.data_ptr(), dw_part.data_ptr(),
                                       dw.data_ptr(), db.data_ptr(), db_part.shape[0],
                                       dw_part.shape[0], *width, stream)),
                (dx, dw, db))

    def run(x, wb, wt, bp, g):
        rows, wgrad, out = passes(x, wb, wt, bp, g)
        rows()
        wgrad()
        return out
    run.passes = passes
    return run


def trunk_bwd_main(torch, chip_smoke, libs, nodin, dev) -> int:
    """Kernel 6's versions at TRUNK_SHAPES (module docstring); those in
    ``nodin`` with the weight-gradient launcher before its redesign."""
    from dgmesh_torch.ops import mlp_fused as MF
    runs = {src: trunk_bwd_launcher(torch, lib, src in nodin) for src, (lib, _) in libs.items()}
    rng = np.random.default_rng(0)
    for n, din in TRUNK_SHAPES:
        _, wb, bp = chip_smoke.random_trunk(torch, din, dev, seed=0)
        wt = MF.transpose_pack(wb)
        x = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, din)).astype(np.float32), device=dev)
        g = torch.as_tensor(rng.normal(size=(n, 256)).astype(np.float32), device=dev)
        want = MF.trunk_bwd_ref(x, wb, bp, g)
        times = timed_rounds(torch, chip_smoke, runs, lambda src: runs[src](x, wb, wt, bp, g))
        big = torch.ones((MF.BWD_BUFFERS, -(-n // MF.BWD_ROWS) * MF.BWD_ROWS, 256),
                         dtype=torch.bfloat16, device=dev)
        read_ms = chip_smoke.time_cuda(torch, lambda: big.sum(dtype=torch.float32), LAUNCHES)
        print(f"# read yardstick ({n},{din}): torch.sum over a workspace-sized bf16 tensor "
              f"({big.numel() * 2 / 1e9:.3f} GB) {read_ms:.4f} ms, "
              f"{big.numel() * 2 / read_ms / 1e9:.3f} TB/s", flush=True)
        del big
        wgrads = {}
        for src, run in runs.items():
            rows, wgrads[src], _ = run.passes(x, wb, wt, bp, g)
            rows()
        wtimes = timed_rounds(torch, chip_smoke, runs, lambda src: wgrads[src]())
        del wgrads
        first = None
        for src, run in runs.items():
            got, again = run(x, wb, wt, bp, g), run(x, wb, wt, bp, g)
            first = got if first is None else first
            rep = {}
            for name, a, b in zip(("dx", "dW", "db"), got, want):
                d = a.double() - b.double()
                rep[name] = (float(d.abs().max()) / float(b.abs().max()),
                             float(d.norm()) / float(b.double().norm()))
            ok = (all(v[1] <= chip_smoke.TOL_MLP_BWD_NORM for v in rep.values())
                  and all(rep[k][0] <= chip_smoke.TOL_MLP_BWD_MAX for k in ("dW", "db")))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            same_first = all(torch.equal(a, b) for a, b in zip(got, first))
            print(f"# {src} ({n},{din}): {' / '.join(f'{t:.4f}' for t in times[src])} "
                  f"ms/call, of it the weight-gradient pass + reductions "
                  f"{' / '.join(f'{t:.4f}' for t in wtimes[src])} ms; "
                  + ", ".join(f"{k} max {v[0]:.3g} norm {v[1]:.3g}" for k, v in rep.items())
                  + f" {'agrees' if ok else 'DISAGREES'} with the twin; two calls "
                  f"{'identical' if same else 'DIFFERENT'}; "
                  f"{'the same bits as' if same_first else 'OTHER bits than'} "
                  f"the first source", flush=True)
        del x, g, want, got, again, first
    return 0


def training_rows(torch, chip_smoke, dev):
    """The shade backward's arguments in one float32 training step: rows,
    cotangents, geometry and the forward's residuals."""
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.train import step
    from dgmesh_torch.train.step import StepContext
    cfg = chip_smoke.load_cfg()
    ctx = StepContext(cfg, chip_smoke.IMG, chip_smoke.IMG, device=dev)
    state = chip_smoke.build_shell_state(torch, cfg, chip_smoke.N_GAUSS, dev)
    batch = chip_smoke.bench_batch(chip_smoke.IMG, chip_smoke.IMG, dev)
    flags = chip_smoke.train_flags(step, cfg.model.sh_degree)
    _, _, args = chip_smoke.call_by_stage(
        torch, [(MK, "shade_bwd", "shade_bwd_kernel")],
        lambda: step.train_step(ctx, state, batch, flags), 1, what="train_step")
    a, g, gs = (x.detach() for x in args["shade_bwd_kernel"][:3])
    g, gs = (x / x.abs().max().clamp_min(1e-30) for x in (g, gs))
    return a, g, gs, args["shade_bwd_kernel"][3:7], args["shade_bwd_kernel"][7:9]


def random_rows(torch, chip_smoke, dev):
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    from dgmesh_torch.train.step import StepContext
    mc = StepContext(chip_smoke.load_cfg(), chip_smoke.IMG, chip_smoke.IMG, device=dev).mr_cfg
    rng = np.random.default_rng(0)
    a = chip_smoke.shade_tie_attrs(rng, mc.num_tiles, mc.max_per_tile, mc.tiles_x, mc.tile_w)
    g, gs = chip_smoke.cotangents(rng, mc.num_tiles, mc.tile_h * mc.tile_w)
    a, g, gs = (torch.as_tensor(x, device=dev) for x in (a, g, gs))
    geo = (mc.tiles_x, mc.tile_h, mc.tile_w, mc.sigma)
    return a, g, gs, geo, MK.shade_tiles(a, *geo, residuals=True)[4:]


def shade_fwd_launcher(torch, lib):
    """The version's kernel 3 on (attrs, geometry) → (rgb, hard, soft, fid)
    and, with ``residuals``, (win, M)."""
    fn = lib.shade_tiles_launch
    t0 = tile0_args(lib)
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * (5 + len(t0))
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(attrs, tiles_x, tile_h, tile_w, sigma, residuals=False):
        T, K, _ = attrs.shape
        P = tile_h * tile_w
        f32 = dict(dtype=torch.float32, device=attrs.device)
        out = (torch.empty((T, P, 3), **f32),) + tuple(torch.empty((T, P), **f32)
                                                      for _ in range(3))
        res = ((torch.empty((T, P), dtype=torch.int32, device=attrs.device),
                torch.empty((T, P), **f32)) if residuals else ())
        err = fn(attrs.data_ptr(), *(x.data_ptr() for x in out),
                 *([x.data_ptr() for x in res] or [None, None]),
                 T, K, tiles_x, tile_h, tile_w, *t0, float(sigma),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"shade_tiles_launch failed with cudaError {err}")
        return out + res
    return run


def render_rows(torch, chip_smoke, dev, owner, attr, n_geo):
    """The arguments of ``owner.attr`` in chip_smoke.py's render of view 0:
    rows and ``n_geo`` geometry arguments; kernel 3's (mesh_raster_kernels,
    ``shade_tiles``, 4) or kernel 1's (splat_kernels, ``composite_tiles``,
    3)."""
    from dgmesh_torch.eval.testing import render_frame_with_aux
    from dgmesh_torch.train.step import StepContext
    cfg = chip_smoke.load_cfg()
    ctx = StepContext(cfg, chip_smoke.IMG, chip_smoke.IMG, device=dev)
    state = chip_smoke.build_shell_state(torch, cfg, chip_smoke.N_GAUSS, dev)
    batch = chip_smoke.view_batches(chip_smoke.IMG, chip_smoke.IMG, chip_smoke.N_VIEWS, dev)[0]
    with torch.no_grad():
        _, _, args = chip_smoke.call_by_stage(
            torch, [(owner, attr, "kernel")],
            lambda: render_frame_with_aux(ctx, state, batch, cfg.model.sh_degree), 1)
    return args["kernel"][0], tuple(args["kernel"][1:1 + n_geo])


def shade_fwd_main(torch, chip_smoke, libs, dev) -> int:
    """Kernel 3's versions (module docstring)."""
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    if "--random" in sys.argv[1:]:
        a, _, _, geo, _ = random_rows(torch, chip_smoke, dev)
        sets = [("random rows", a, geo)]
    else:
        a, _, _, geo, _ = training_rows(torch, chip_smoke, dev)
        sets = [("render view 0's rows",
                 *render_rows(torch, chip_smoke, dev, MK, "shade_tiles", 4)),
                ("a float32 step's rows", a, geo)]
    runs = {src: shade_fwd_launcher(torch, lib) for src, (lib, _) in libs.items()}
    for what, a, geo in sets:
        valid = (a[..., 9] > 0.5).sum(1)
        print(f"# {what} {tuple(a.shape)}: {int(valid.sum())} valid in "
              f"{int((valid > 0).sum())} tiles, largest tile {int(valid.max())}, tiles at K "
              f"{int((valid == a.shape[1]).sum())}", flush=True)
        want = MK.shade_tiles_ref(a, *geo, residuals=True)
        times = {mode: timed_rounds(torch, chip_smoke, runs,
                                    lambda src: runs[src](a, *geo, residuals=mode))
                 for mode in (False, True)}
        first = None
        for src, run in runs.items():
            got, again = run(a, *geo, residuals=True), run(a, *geo, residuals=True)
            plain = run(a, *geo)
            first = got if first is None else first
            err = chip_smoke.max_err((got[0], got[2]), (want[0], want[2]))
            exact = all(bool(torch.equal(got[i], want[i])) for i in (1, 3, 4))
            m_ok = bool(((got[5] - want[5]).abs()
                         <= chip_smoke.TOL_SHADE * want[5].abs().clamp_min(1.0)).all())
            ok = err <= chip_smoke.TOL_SHADE and exact and m_ok
            same = lambda x, y: all(bool(torch.equal(u, v)) for u, v in zip(x, y))
            print(f"# {src}: render {' / '.join(f'{t:.4f}' for t in times[False][src])}, "
                  f"training {' / '.join(f'{t:.4f}' for t in times[True][src])} ms/launch; "
                  f"rgb, soft max_abs_err {err:.3g}; hard, fid, win "
                  f"{'exact' if exact else 'NOT EXACT'}, M {'ok' if m_ok else 'off'}: "
                  f"{'agrees' if ok else 'DISAGREES'} with the twin; without residuals "
                  f"{'the same' if same(plain, got[:4]) else 'OTHER'} outputs; two launches "
                  f"{'identical' if same(got, again) else 'DIFFERENT'}; "
                  f"{'the same bits as' if same(got, first) else 'OTHER bits than'} "
                  f"the first source", flush=True)
        del want
    return 0


def composite_launcher(torch, lib, res):
    """The version's kernel 2 on (attrs, g_rgb, g_alpha, geometry), through
    its residual entry point with ``res`` (rgb, S) where it has one."""
    with_res = hasattr(lib, "composite_bwd_res_launch")
    fn = lib.composite_bwd_res_launch if with_res else lib.composite_bwd_launch
    res = res if with_res else ()
    t0 = tile0_args(lib)
    fn.argtypes = ([ctypes.c_void_p] * (4 + len(res)) + [ctypes.c_int] * (5 + len(t0))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(attrs, g_rgb, g_alpha, tiles_x, tile_h, tile_w):
        T, K, _ = attrs.shape
        d = torch.empty_like(attrs)
        err = fn(attrs.data_ptr(), g_rgb.data_ptr(), g_alpha.data_ptr(),
                 *(x.data_ptr() for x in res), d.data_ptr(), T, K, tiles_x, tile_h, tile_w,
                 *t0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"composite_bwd launch failed with cudaError {err}")
        return d
    return run


def composite_rows(torch, chip_smoke, dev, random, need_res):
    """Kernel 2's arguments: a float32 training step's (``random`` False) or
    chip_smoke.py's random composite rows and cotangents, the geometry, and
    where ``need_res`` the forward's residuals (rgb, S) for these rows."""
    from dgmesh_torch.ops import splat_kernels as SK
    from dgmesh_torch.train.step import StepContext
    if random:
        sc = StepContext(chip_smoke.load_cfg(), chip_smoke.IMG, chip_smoke.IMG,
                         device=dev).splat_cfg
        rng = np.random.default_rng(0)
        a = chip_smoke.random_composite_attrs(rng, sc.num_tiles, sc.max_per_tile, sc.tiles_x,
                                              sc.tile_w)
        g, ga = chip_smoke.cotangents(rng, sc.num_tiles, sc.tile_h * sc.tile_w)
        a, g, ga = (torch.as_tensor(x, device=dev) for x in (a, g, ga))
        geo = (sc.tiles_x, sc.tile_h, sc.tile_w)
    else:
        from dgmesh_torch.train import step
        cfg = chip_smoke.load_cfg()
        ctx = StepContext(cfg, chip_smoke.IMG, chip_smoke.IMG, device=dev)
        state = chip_smoke.build_shell_state(torch, cfg, chip_smoke.N_GAUSS, dev)
        batch = chip_smoke.bench_batch(chip_smoke.IMG, chip_smoke.IMG, dev)
        flags = chip_smoke.train_flags(step, cfg.model.sh_degree)
        _, _, args = chip_smoke.call_by_stage(
            torch, [(SK, "composite_bwd", "composite_bwd_kernel")],
            lambda: step.train_step(ctx, state, batch, flags), 1, what="train_step")
        a, g, ga = (x.detach() for x in args["composite_bwd_kernel"][:3])
        g, ga = (x / x.abs().max().clamp_min(1e-30) for x in (g, ga))
        geo = tuple(args["composite_bwd_kernel"][3:6])
    res = SK.composite_tiles(a, *geo, residuals=True)[0::2] if need_res else ()
    return a, g, ga, geo, res


def composite_fwd_launcher(torch, lib, with_s):
    """The version's kernel 1 on (attrs, geometry) → (rgb, alpha, S or
    None); S is asked for only where ``s_out`` and the version has it."""
    fn = lib.composite_tiles_launch
    t0 = tile0_args(lib)
    fn.argtypes = ([ctypes.c_void_p] * (4 if with_s else 3) + [ctypes.c_int] * (5 + len(t0))
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(attrs, tiles_x, tile_h, tile_w, s_out=False):
        T, K, _ = attrs.shape
        P = tile_h * tile_w
        rgb = torch.empty((T, P, 3), dtype=torch.float32, device=attrs.device)
        alpha = torch.empty((T, P), dtype=torch.float32, device=attrs.device)
        S = torch.empty_like(alpha) if s_out and with_s else None
        ptrs = [attrs.data_ptr(), rgb.data_ptr(), alpha.data_ptr()]
        ptrs += [S.data_ptr() if S is not None else None] if with_s else []
        err = fn(*ptrs, T, K, tiles_x, tile_h, tile_w, *t0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"composite_tiles_launch failed with cudaError {err}")
        return rgb, alpha, S
    return run


def composite_block_stats(torch, SK, a, geo, chunk=50):
    """(pixel, row) pairs of valid rows and of those that pass kernel 1's
    gate; and per warp layout (8x4 pixel blocks, or two 16-pixel rows of a
    16x16 tile) the (warp, valid row) pairs and those where some pixel of the
    warp passes: how much a warp-uniform skip of a row could leave out; and
    the 8x4 blocks that meet the bounding box of the row's gate ellipse."""
    T, K, _ = a.shape
    tiles_x, th, tw = geo
    px, py = SK.tile_pixels(T, tiles_x, th, tw, 0.0, a.device)
    n = {"valid": 0, "pass": 0, "8x4 warps": [0, 0], "16x2 warps": [0, 0], "8x4 boxes": 0}
    with torch.no_grad():
        for s in range(0, T, chunk):
            at = a[s:s + chunk]
            dx = at[..., 0:1] - px[s:s + chunk, None]
            dy = at[..., 1:2] - py[s:s + chunk, None]
            pw = -0.5 * (at[..., 2:3] * dx * dx + at[..., 4:5] * dy * dy) - at[..., 3:4] * dx * dy
            al = torch.clamp_max(at[..., 5:6] * torch.exp(pw), SK.ALPHA_MAX)
            valid = at[..., 9] > 0.5
            ok = (pw <= 0) & (al >= SK.ALPHA_MIN) & valid[..., None]
            n["valid"] += int(valid.sum()) * th * tw
            n["pass"] += int(ok.sum())
            if (th, tw) == (16, 16):
                c = ok.shape[0]
                blk = ok.reshape(c, K, 4, 4, 2, 8).any(5).any(3)
                row = ok.reshape(c, K, 8, 32).any(3)
                for key, b in (("8x4 warps", blk), ("16x2 warps", row)):
                    n[key][0] += int(valid.sum()) * 8
                    n[key][1] += int(b.sum())
                # the gate's ellipse o e^power >= 1/255 has the bounding box
                # |dx| <= sqrt(R2 c / det), |dy| <= sqrt(R2 a / det), with
                # R2 = 2 ln(255 o): the 8x4 blocks a box test leaves in
                d = at.double()
                ca, cb, cc, o = d[..., 2], d[..., 3], d[..., 4], d[..., 5]
                det = ca * cc - cb * cb
                r2 = 2.0 * torch.log(o / SK.ALPHA_MIN)
                hx = torch.sqrt((r2 * cc / det).clamp_min(0.0))[..., None, None]
                hy = torch.sqrt((r2 * ca / det).clamp_min(0.0))[..., None, None]
                x0 = px[s:s + chunk].reshape(c, 4, 4, 2, 8)[:, 0, 0, :, 0].double()
                y0 = py[s:s + chunk].reshape(c, 4, 4, 2, 8)[:, :, 0, 0, 0].double()
                x0, y0 = x0[:, None, None, :], y0[:, None, :, None]
                mx, my = d[..., 0][..., None, None], d[..., 1][..., None, None]
                keep = ((x0 + 7 >= mx - hx) & (x0 <= mx + hx) & (y0 + 3 >= my - hy)
                        & (y0 <= my + hy) & (r2 >= 0)[..., None, None])
                n["8x4 boxes"] += int((keep & valid[..., None, None]).sum())
    return n


def composite_fwd_main(torch, chip_smoke, libs, no_s, dev) -> int:
    """Kernel 1's versions (module docstring); those in ``no_s`` take no S."""
    from dgmesh_torch.ops import splat_kernels as SK
    if "--random" in sys.argv[1:]:
        a, _, _, geo, _ = composite_rows(torch, chip_smoke, dev, True, False)
        sets = [("random rows", a, geo)]
    else:
        a, _, _, geo, _ = composite_rows(torch, chip_smoke, dev, False, False)
        sets = [("render view 0's rows",
                 *render_rows(torch, chip_smoke, dev, SK, "composite_tiles", 3)),
                ("a float32 step's rows", a, geo)]
    runs = {src: composite_fwd_launcher(torch, lib, src not in no_s)
            for src, (lib, _) in libs.items()}
    for what, a, geo in sets:
        valid = (a[..., 9] > 0.5).sum(1)
        st = composite_block_stats(torch, SK, a, geo)
        print(f"# {what} {tuple(a.shape)}: {int(valid.sum())} valid in "
              f"{int((valid > 0).sum())} tiles, largest tile {int(valid.max())}, tiles at K "
              f"{int((valid == a.shape[1]).sum())}; (pixel, valid row) pairs {st['valid']}, "
              f"{st['pass']} passing; (warp, valid row) pairs with a passing pixel: "
              + ", ".join(f"{k} {st[k][1]} of {st[k][0]}" for k in ("8x4 warps", "16x2 warps"))
              + f"; 8x4 warps inside the gate ellipse's bounding box {st['8x4 boxes']}",
              flush=True)
        want = SK.composite_tiles_ref(a, *geo, residuals=True)
        times = {mode: timed_rounds(torch, chip_smoke, runs,
                                    lambda src: runs[src](a, *geo, s_out=mode))
                 for mode in (False, True)}
        first = None
        for src, run in runs.items():
            got, again = run(a, *geo, s_out=True), run(a, *geo, s_out=True)
            plain = run(a, *geo)
            first = got if first is None else first
            err = chip_smoke.max_err(got[:2], want[:2])
            same = lambda x, y: all(u is None or v is None or bool(torch.equal(u, v))
                                    for u, v in zip(x, y))
            line = (f"# {src}: render {' / '.join(f'{t:.4f}' for t in times[False][src])}, "
                    f"training {' / '.join(f'{t:.4f}' for t in times[True][src])} ms/launch; "
                    f"rgb, alpha max_abs_err {err:.3g} "
                    f"{'agrees' if err <= chip_smoke.TOL_COMPOSITE else 'DISAGREES'} with the "
                    f"twin")
            if got[2] is not None:
                s_ok = bool(((got[2] - want[2]).abs()
                             <= chip_smoke.TOL_COMPOSITE * want[2].abs().clamp_min(1.0)).all())
                line += (f", S {'agrees' if s_ok else 'DISAGREES'}; without S "
                         f"{'the same' if same(plain[:2], got[:2]) else 'OTHER'} rgb, alpha")
            line += (f"; two launches {'identical' if same(got, again) else 'DIFFERENT'}; "
                     f"{'the same bits as' if same(got, first) else 'OTHER bits than'} "
                     f"the first source")
            print(line, flush=True)
        del want
    return 0


def composite_bwd_main(torch, chip_smoke, libs, dev) -> int:
    """Kernel 2's versions (module docstring)."""
    from dgmesh_torch.ops import splat_kernels as SK
    need_res = any(hasattr(lib, "composite_bwd_res_launch") for lib, _ in libs.values())
    a, g, ga, geo, res = composite_rows(torch, chip_smoke, dev, "--random" in sys.argv[1:],
                                        need_res)
    valid = (a[..., 9] > 0.5).sum(1)
    print(f"# composite rows {tuple(a.shape)}: {int(valid.sum())} valid in "
          f"{int((valid > 0).sum())} tiles, largest tile {int(valid.max())}, tiles at K "
          f"{int((valid == a.shape[1]).sum())}", flush=True)
    want = SK.composite_bwd_ref(a, g, ga, *geo)
    runs = {src: composite_launcher(torch, lib, res) for src, (lib, _) in libs.items()}
    times = timed_rounds(torch, chip_smoke, runs, lambda src: runs[src](a, g, ga, *geo))
    first = None
    for src, run in runs.items():
        got, again = run(a, g, ga, *geo), run(a, g, ga, *geo)
        first = got if first is None else first
        e, ok, rep = chip_smoke.compare_bwd(torch, got, want, chip_smoke.COMPOSITE_GROUPS,
                                            chip_smoke.ZERO_LANES["composite"], a[..., 9] < 0.5)
        print(f"# {src}: {' / '.join(f'{t:.4f}' for t in times[src])} ms/launch; "
              + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
              + f" {'agrees' if ok else 'DISAGREES'} with the twin; two launches "
              f"{'identical' if torch.equal(got, again) else 'DIFFERENT'}; "
              f"{'the same bits as' if torch.equal(got, first) else 'OTHER bits than'} "
              f"the first source", flush=True)
    return 0


def tail_report(torch, d, valid):
    """Where a version's blocks ran and when, from a tail probe: a version
    that writes, for each block, its SM id and the %globaltimer (ns) at its
    start and end into lanes 20-22 of a row of its tile that no other block
    writes (else None)."""
    u = d[..., 20:23].contiguous().view(torch.int32).long() & 0xFFFFFFFF
    stamped = u[..., 2] != 0
    if not bool(stamped.any()):
        return None
    sm, t0, t1 = u[stamped].unbind(1)
    valid = valid[:, None].expand(-1, d.shape[1])[stamped]
    base = int(t0.min())
    t0, t1 = (t0 - base) % 2**32, (t1 - base) % 2**32
    span = float(t1.max())
    last = torch.zeros(int(sm.max()) + 1, dtype=torch.long, device=d.device)
    last = last.scatter_reduce(0, sm, t1, "amax").float()[torch.unique(sm)] / 1e3
    q = torch.quantile(last, torch.tensor([0.0, 0.5, 1.0], device=d.device)).tolist()
    dur = (t1 - t0).float() / 1e3
    full = valid == int(valid.max())
    busy = float(dur.sum()) / last.numel() / (span / 1e3)
    return (f"# tail: {int(stamped.sum())} blocks on {last.numel()} SMs over {span / 1e3:.1f} us; "
            f"each SM's last block ends at {q[0]:.1f} / {q[1]:.1f} / {q[2]:.1f} us (min / "
            f"median / max); block time over SMs x span {busy:.3f}; blocks of the "
            f"{int(full.sum())} fullest tiles {float(dur[full].median()):.1f} us median, "
            f"{float(dur[full].max()):.1f} max; empty tiles "
            f"{float(dur[valid == 0].median()):.2f} us")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dgmesh_torch.ops import mesh_raster_kernels as MK
    named = [s for s in sys.argv[1:] if not s.startswith("--")]
    sources = [s.removesuffix(":transposed").removesuffix(":noS").removesuffix(":nodin")
               for s in named]
    transposed = {s.removesuffix(":transposed") for s in named if s.endswith(":transposed")}
    no_s = {s.removesuffix(":noS") for s in named if s.endswith(":noS")}
    nodin = {s.removesuffix(":nodin") for s in named if s.endswith(":nodin")}
    print(chip_smoke.card_line(), flush=True)
    libs = build(sources, os.path.join(ROOT, "build", "variants"))
    for src, (_, lines) in libs.items():
        for ln in lines:
            print(f"# {src}: {ln}")
    dev = torch.device("cuda")
    if all(hasattr(lib, "mlp_fwd_launch") for lib, _ in libs.values()):
        return trunk_fwd_main(torch, chip_smoke, libs, transposed, dev)
    if all(hasattr(lib, "mlp_bwd_rows_launch") for lib, _ in libs.values()):
        return trunk_bwd_main(torch, chip_smoke, libs, nodin, dev)
    if all(hasattr(lib, "shade_tiles_launch") for lib, _ in libs.values()):
        return shade_fwd_main(torch, chip_smoke, libs, dev)
    if all(hasattr(lib, "composite_tiles_launch") for lib, _ in libs.values()):
        return composite_fwd_main(torch, chip_smoke, libs, no_s, dev)
    if all(hasattr(lib, "composite_bwd_launch") or hasattr(lib, "composite_bwd_res_launch")
           for lib, _ in libs.values()):
        return composite_bwd_main(torch, chip_smoke, libs, dev)
    rows = random_rows if "--random" in sys.argv[1:] else training_rows
    a, g, gs, geo, res = rows(torch, chip_smoke, dev)
    valid = (a[..., 9] > 0.5).sum(1)
    print(f"# rows {tuple(a.shape)}: {int(valid.sum())} valid in {int((valid > 0).sum())} "
          f"tiles, largest tile {int(valid.max())}, tiles at K {int((valid == a.shape[1]).sum())}",
          flush=True)
    want = MK.shade_bwd_ref(a, g, gs, *geo)
    runs = {src: launcher(torch, lib, res) for src, (lib, _) in libs.items()}
    times = timed_rounds(torch, chip_smoke, runs, lambda src: runs[src](a, g, gs, *geo))
    first = None
    for src in sources:
        got, again = runs[src](a, g, gs, *geo), runs[src](a, g, gs, *geo)
        first = got if first is None else first
        e, ok, rep = chip_smoke.compare_bwd(torch, got, want, chip_smoke.SHADE_GROUPS,
                                            chip_smoke.ZERO_LANES["shade"], a[..., 9] < 0.5)
        print(f"# {src}: {' / '.join(f'{t:.4f}' for t in times[src])} ms/launch; "
              + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
              + f" {'agrees' if ok else 'DISAGREES'} with the twin; two launches "
              f"{'identical' if torch.equal(got, again) else 'DIFFERENT'}; "
              f"{'the same bits as' if torch.equal(got, first) else 'OTHER bits than'} "
              f"the first source", flush=True)
        tail = tail_report(torch, got, valid)
        if tail:
            print(tail, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
