"""Render traffic: one client in a closed loop over a test split of distinct
(camera, time) views, cycled, each through ``eval/testing.py::render_frame``
with the mesh, and timed until its images are on the host.

The mix's parameters (``portbench/workloads/<traffic>.json``):
  views    distinct test views on the orbit, at times between the
           training views'
  step     the state's completed iterations (the SH degree follows)
  sample   views whose outputs are compared with the reference

Set-up: the state, the views, one render of each (every shape the window
uses).  The window renders views in order until ``--seconds`` pass; the
first window output of each sampled view is kept on the host.  With
``--trace 1`` one more cycle runs under the profiler, its work counted.
Last, with the program's state freed, the reference renders the sampled
views from the same inputs.
"""

from __future__ import annotations

import contextlib
import random
import sys
import time

import numpy as np
import torch

from portbench import harness as H
from portbench.counts import work as W
from portbench.inputs import (camera, make_views, program_state, raw_state, reference_state,
                              reference_view)
from portbench.reference import step as RS
from portbench.spec import build_config, load_program


def views_of(spec, seed: int):
    return make_views(spec.config["camera"], spec.mix["views"], seed, test=True)


def batches(P, cfg, views, device):
    blender = cfg.model.is_blender
    bg = np.array([1, 1, 1] if cfg.model.white_background else [0, 0, 0], np.float32)
    return [P.step.make_batch(camera(P, v, blender), 1.0 / len(views), bg, device)
            for v in views]


def host_outputs(out) -> dict:
    """The render's images and mesh size, copied to the host."""
    return {"render": out["render"].cpu(), "mesh_image": out["mesh_image"].cpu(),
            "mask": out["mask"].cpu(), "n_verts": int(out["n_verts"]),
            "n_faces": int(out["n_faces"])}


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """Worst over the sampled views: the splat image's mean and largest
    gaps, the mesh image's mean gap and the share of pixels whose coverage
    differs (the mesh's vertices and faces reach the images through the
    raster); and the reference's mesh overflow, which has to be 0: a mesh
    cut at the caps is no answer.  The numbers the limits name are
    compared; all are printed.  The splat's largest gap is a reading only:
    where two Gaussians' depths straddle a boundary of the binning's 14-bit
    depth buckets, rounding decides their order on each side, and one
    pixel's colour moves by up to a Gaussian's contribution."""
    vals = dict(image_mean=0.0, image_max=0.0, mesh_image_mean=0.0, mask_share=0.0,
                mesh_overflow=max(r["overflow"] for r in ref.values()))
    for k, p in prog.items():
        r = ref[k]
        d = (p["render"] - r["render"]).abs()
        vals["image_mean"] = max(vals["image_mean"], float(d.mean()))
        vals["image_max"] = max(vals["image_max"], float(d.max()))
        vals["mesh_image_mean"] = max(vals["mesh_image_mean"],
                                      float((p["mesh_image"] - r["mesh_image"]).abs().mean()))
        vals["mask_share"] = max(vals["mask_share"],
                                 float((p["mask"] != r["mask"]).float().mean()))
    H.stderr("# compared views " + ", ".join(
        f"{k}: verts {prog[k]['n_verts']}/{ref[k]['n_verts']} faces "
        f"{prog[k]['n_faces']}/{ref[k]['n_faces']}" for k in sorted(prog))
        + "; readings " + ", ".join(f"{k} {v:.6g}" for k, v in vals.items()))
    return {k: {"value": float(vals[k]), "limit": float(v)} for k, v in limits.items()}


def reference_views(spec, seed: int, device, raw, keys) -> dict:
    """The reference's renders of the views ``keys`` from the same inputs."""
    conf, mix = spec.config, spec.mix
    ctx = RS.Ctx(conf["config"], device)
    views = views_of(spec, seed)
    st = reference_state(conf, raw, mix["step"])
    sh = min(mix["step"] // 1000, conf["config"]["model"]["sh_degree"])
    out = {}
    for k in keys:
        r = RS.render_view(ctx, st, reference_view(views[k], len(views), ctx.blender, device), sh)
        out[k] = {"render": r["render"].cpu(), "mesh_image": r["mesh_image"].cpu(),
                  "mask": r["mask"].cpu(), "n_verts": r["n_verts"], "n_faces": r["n_faces"],
                  "overflow": float(r["overflow"])}
    return out


def run(spec, seed: int, seconds: float, trace: bool, device, t_start: float,
        tmp_dir: str, control: bool = False) -> dict:
    P = load_program()
    conf, mix = spec.config, spec.mix
    out = {}
    with contextlib.redirect_stdout(sys.stderr):
        cfg = build_config(P, conf)
        views = views_of(spec, seed)
        bs = batches(P, cfg, views, device)
        raw = raw_state(conf, seed, device)
        state = program_state(P, cfg, raw, mix["step"])
        ctx = P.step.StepContext(cfg, views[0].width, views[0].height, device=device)
        sh = min(mix["step"] // 1000, cfg.model.sh_degree)
        sample = sorted(random.Random(seed).sample(range(len(views)), mix["sample"]))

        def one(i):
            return host_outputs(P.testing.render_frame(ctx, state, bs[i], sh, with_mesh=True))
        for i in range(len(views)):
            one(i)
        H.sync(device)
        setup_s = time.perf_counter() - t_start
        kept, times, i = {}, [], 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            o = one(i % len(views))
            times.append((time.perf_counter() - a) * 1e3)
            if i % len(views) in sample and i % len(views) not in kept:
                kept[i % len(views)] = o
            i += 1
            if time.perf_counter() - t0 >= seconds and len(kept) == len(sample):
                break
        window_s = time.perf_counter() - t0
        out["end_to_end"] = dict(setup_s=setup_s, render_ms=window_s * 1e3 / i,
                                 render_ms_p95=H.quantile(times, 0.95))
        out["attempted"], out["failed"] = i, 0
        if trace:
            out.update(traced(P, cfg, views, one, device, tmp_dir, window_s * 1e3 / i))
        out["device"] = H.device_record(spec.cell["chips"], device)
        H.stderr(f"# window: {i} views in {window_s:.3f} s; peak "
                 f"{out['device']['memory_peak_bytes']} bytes")
        del state, bs, ctx
        H.clear_program_state()
        RS.full_float32()
        ref = reference_views(spec, seed, device, raw, sorted(kept))
        if control:
            with H.lowered("f32"):
                low = reference_views(spec, seed, device, raw, sorted(kept))
            out["control_checks"] = compare(low, ref, spec.limits)
    out["checks"] = compare(kept, ref, spec.limits)
    return out


def traced(P, cfg, views, one, device, tmp_dir: str, view_ms: float) -> dict:
    """One cycle of the views under the profiler, its needed work counted."""
    counter = H.Counter()
    sk, rk = P.splat_kernels, P.raster_kernels
    counter.wrap(sk, "composite_tiles", "composite", H.count_rows(9))
    counter.wrap(rk, "shade_tiles", "shade", H.count_rows(9))
    sizes = []
    orig = P.testing.render_frame_with_aux

    def recorded(ctx, state, batch, sh, with_mesh=True):
        res, aux = orig(ctx, state, batch, sh, with_mesh)
        sizes.append((state.gs.alive.sum(), res["n_verts"]))
        return res, aux
    P.testing.render_frame_with_aux = recorded
    try:
        tr = H.profiled(lambda: [one(i) for i in range(len(views))], device, tmp_dir)
    finally:
        counter.restore()
        P.testing.render_frame_with_aux = orig
    c = counter.totals()
    blender = cfg.model.is_blender
    flops = fft = 0.0
    for alive, verts in sizes:
        a, v = float(alive), float(verts)
        for net, rows in (("deform", a), ("deform_normal", a), ("deform_back", v),
                          ("appearance", v)):
            flops += sum(W.net_flops(rows, blender, net, False, False))
        fft += 2 * W.fft_flops(cfg.model.grid_res)
    n = len(sizes)
    sp, sh_ = c.get("composite", {}), c.get("shade", {})
    raster_f = W.raster_ops(sh_.get("pairs", 0))
    work = dict(
        iterations=n,
        step_least_s=W.least_seconds([(flops, W.PEAK_F32), (fft, W.PEAK_F32),
                                      (raster_f, W.PEAK_F32)]) / n,
        splat_least_s=W.least_seconds([], W.splat_bytes(sp.get("rows", 0), sp.get("pixels", 0),
                                                        False)) / n,
        raster_least_s=W.least_seconds([(raster_f, W.PEAK_F32)],
                                       W.raster_bytes(sh_.get("rows", 0), sh_.get("pixels", 0),
                                                      False, False)) / n)
    rec = dict(kind="render", trace=tr, work=work, timers={}, step_ms=view_ms,
               peak_bytes=torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0)
    return dict(record=rec, busy_s=tr.busy_s, window_s=tr.window_s,
                breakdown={"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})
