#!/usr/bin/env python3
"""Time versions of the port's mesh shade backward (kernel 4) side by side,
at the rows and cotangents of a training step, on one NVIDIA GPU.

    python3 tools/torch_shade_bwd_variants.py [--random] SOURCE.cu ...

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

Printed per source: ptxas's register and spill lines; ms per launch (CUDA
events over 20 launches after a warm-up), measured in two rounds, the
second in reverse order; the error against the plain twin per lane group
(chip_smoke.compare_bwd's limits); whether two launches give the same bits.
A version that leaves work out disagrees with the twin: that is reported,
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


def build(sources, out_dir):
    """nvcc each source into a shared library, all at once; returns
    {source: (library, ptxas lines)}."""
    from dgmesh_torch.ops import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for src in sources:
        text = open(src, "rb").read() + " ".join(cuda_build.NVCC_FLAGS).encode()
        lib = os.path.join(out_dir, f"lib{os.path.basename(src)[:-3]}-"
                                    f"{hashlib.sha256(text).hexdigest()[:12]}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src]
        procs[src] = (None if os.path.exists(lib) else subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for src, (p, lib) in procs.items():
        log = p.communicate()[0] if p else "built before"
        if p and p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        out[src] = (ctypes.CDLL(lib), [ln.strip() for ln in log.splitlines()
                                       if "registers" in ln or "spill" in ln])
    return out


def launcher(torch, lib, res):
    """The version's launch on (attrs, g_rgb, g_soft, geometry), through
    its residual entry point with ``res`` where it has one."""
    with_res = hasattr(lib, "shade_bwd_res_launch")
    fn = lib.shade_bwd_res_launch if with_res else lib.shade_bwd_launch
    res = res if with_res else ()
    fn.argtypes = ([ctypes.c_void_p] * (4 + len(res)) + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(attrs, g_rgb, g_soft, tiles_x, tile_h, tile_w, sigma):
        T, K, _ = attrs.shape
        d = torch.empty_like(attrs)
        err = fn(attrs.data_ptr(), g_rgb.data_ptr(), g_soft.data_ptr(),
                 *(x.data_ptr() for x in res), d.data_ptr(), T, K,
                 tiles_x, tile_h, tile_w, float(sigma), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"shade_bwd_launch failed with cudaError {err}")
        return d
    return run


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
    sources = [s for s in sys.argv[1:] if not s.startswith("--")]
    print(chip_smoke.card_line(), flush=True)
    libs = build(sources, os.path.join(ROOT, "build", "variants"))
    for src, (_, lines) in libs.items():
        for ln in lines:
            print(f"# {src}: {ln}")
    dev = torch.device("cuda")
    rows = random_rows if "--random" in sys.argv[1:] else training_rows
    a, g, gs, geo, res = rows(torch, chip_smoke, dev)
    valid = (a[..., 9] > 0.5).sum(1)
    print(f"# rows {tuple(a.shape)}: {int(valid.sum())} valid in {int((valid > 0).sum())} "
          f"tiles, largest tile {int(valid.max())}, tiles at K {int((valid == a.shape[1]).sum())}",
          flush=True)
    want = MK.shade_bwd_ref(a, g, gs, *geo)
    runs = {src: launcher(torch, lib, res) for src, (lib, _) in libs.items()}
    times = {src: [] for src in sources}
    for order in (sources, sources[::-1]):
        for src in order:
            fn = runs[src]
            times[src].append(chip_smoke.time_cuda(
                torch, lambda: fn(a, g, gs, *geo), LAUNCHES))
    for src in sources:
        got, again = runs[src](a, g, gs, *geo), runs[src](a, g, gs, *geo)
        e, ok, rep = chip_smoke.compare_bwd(torch, got, want, chip_smoke.SHADE_GROUPS,
                                            chip_smoke.ZERO_LANES["shade"], a[..., 9] < 0.5)
        print(f"# {src}: {' / '.join(f'{t:.4f}' for t in times[src])} ms/launch; "
              + ", ".join(f"{k} {v[0]:.3g} (tol {v[1]:.3g})" for k, v in rep.items())
              + f" {'agrees' if ok else 'DISAGREES'} with the twin; two launches "
              f"{'identical' if torch.equal(got, again) else 'DIFFERENT'}", flush=True)
        tail = tail_report(torch, got, valid)
        if tail:
            print(tail, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
