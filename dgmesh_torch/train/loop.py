"""The training loop: phase flags, the structural ops, and the trainer.

Counterpart of dgmesh_tpu/train/loop.py (reference train.py training()
:50-556): ``flags_for`` picks the static phase gates of an iteration,
``anchor_fn`` is the loop's anchor step (``Trainer._anchor_fn``),
``run_iteration`` is the iteration body on a given batch, and ``Trainer``
drives them from a Scene: the initial state, the seeded camera order, the
per-camera batch cache, per-iteration random streams from (seed,
iteration) only (so a resume replays the same stream), the four
tripwires, the debug images, and ``train``'s log line and checkpoints.
JAX's scan dispatch (``_scan_fn``, ``run_chunk``) is a TPU workaround and
is not ported: every iteration runs through ``run_iteration``.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..device import DeviceLike, resolve_device
from .densify import anchor_step, densify_and_prune, normal_initialization, reset_opacity
from .state import DENSITY_THRES_BOUND, TrainState, init_state
from .step import (Batch, StepContext, StepFlags, _deform_all, extract_mesh, make_batch,
                   train_step)


def flags_for(cfg: Config, it: int) -> StepFlags:
    """The phase gates of iteration ``it`` (dgmesh_tpu/train/loop.py:155-171):
    Gaussian Adam is skipped on anchor and densify iterations, as the
    reference's tensor swap makes it."""
    o = cfg.optimization
    mesh = it >= o.dpsr_iter
    anchor = (mesh and it > o.anchor_iter and it % o.anchor_interval == 0
              and cfg.model.use_anchor > 0)
    densify_now = (o.densify_from_iter < it < o.densify_until_iter
                   and it % o.densification_interval == 0)
    return StepFlags(
        warm=it < o.warm_up,
        mesh=mesh,
        freeze_pos=it < o.dpsr_iter + o.normal_warm_up,
        use_normal=it >= o.dpsr_iter + o.normal_net_warmup,
        anchor=anchor,
        skip_gaussian_update=anchor or densify_now,
        densify_stats=it < o.densify_until_iter,
        sh_degree=min(it // 1000, cfg.model.sh_degree))


@torch.no_grad()
def anchor_fn(ctx: StepContext, state: TrainState, batch: Batch,
              gen: Optional[torch.Generator] = None, draws: Optional[dict] = None):
    """The anchor step of an iteration (dgmesh_tpu/train/loop.py:115-132):
    the Gaussians deformed with float32 nets (the search radius is ~1e-3,
    as large as bf16 rounding), the mesh extracted with frozen positions,
    then ``anchor_step`` on it.  Returns anchor_step's (gp, gs, mu, nu,
    AnchorInfo)."""
    cf = ctx.f32()
    d_xyz, _, _, d_normal = _deform_all(state.nets, state.gp.xyz, batch.fid, True, mode="f32")
    mesh = extract_mesh(cf, state.gp, state.gs, d_xyz, d_normal, freeze_pos=True)
    return anchor_step(ctx.cfg, state.gp, state.gs, state.g_mu, state.g_nu, state.nets,
                       batch.fid, mesh.verts, mesh.faces, mesh.face_valid, gen=gen, draws=draws)


def run_iteration(ctx: StepContext, state: TrainState, batch: Batch, it: int, extent,
                  gen: Optional[torch.Generator] = None, draws: Optional[dict] = None):
    """One training iteration on ``batch`` (Trainer.run_iteration,
    dgmesh_tpu/train/loop.py:316-363, without the camera choice), in order:
    the one-shot normal init at dpsr_iter; the anchor step; ``train_step``
    with the anchor info; on an anchor iteration the anchored Gaussians,
    statistics and moments replace the step's; densify/prune and the
    opacity reset on their schedule.  ``extent`` is the scene's camera
    extent.  ``state`` is not modified.

    Random draws come from ``gen``, or from ``draws``: {"normal_init":
    {"u", "uv"} (normal_initialization's), "anchor": anchor_step's draws,
    "split": densify_and_prune's split_normals}.  Returns (new state,
    metrics), the anchor step's counters as ``anchor_*``."""
    cfg = ctx.cfg
    o = cfg.optimization
    draws = draws or {}
    flags = flags_for(cfg, it)

    if it == o.dpsr_iter:                                 # train.py:243-246
        gp, _ = normal_initialization(cfg, state.gp, state.gs, state.nets, batch.fid,
                                      occ_res=min(cfg.model.grid_res, cfg.tpu.occ_res),
                                      gen=gen, **draws.get("normal_init", {}))
        state = state._replace(gp=gp)

    anchored = None
    if flags.anchor:
        anchored = anchor_fn(ctx, state, batch, gen, draws.get("anchor"))
    new_state, metrics = train_step(ctx, state, batch, flags, gen,
                                    None if anchored is None else anchored[4])
    if anchored is not None:
        gp, gs, mu, nu, info = anchored
        new_state = new_state._replace(gp=gp, gs=gs, g_mu=mu, g_nu=nu)
        metrics.update({f"anchor_{k}": v for k, v in info.stats.items()})

    if flags.densify_stats and not flags.anchor:          # train.py:489-515
        if it > o.densify_from_iter and it % o.densification_interval == 0:
            gp, gs, mu, nu, _ = densify_and_prune(
                cfg, new_state.gp, new_state.gs, new_state.g_mu, new_state.g_nu, extent,
                it > o.opacity_reset_interval, gen=gen, split_normals=draws.get("split"))
            new_state = new_state._replace(gp=gp, gs=gs, g_mu=mu, g_nu=nu)
        if it % o.opacity_reset_interval == 0 or (cfg.model.white_background
                                                  and it == o.densify_from_iter):
            gp, mu, nu = reset_opacity(new_state.gp, new_state.g_mu, new_state.g_nu)
            new_state = new_state._replace(gp=gp, g_mu=mu, g_nu=nu)
    return new_state, metrics


class TrainingHalted(RuntimeError):
    """Raised by the trainer's tripwires."""


class Trainer:
    """The training driver (dgmesh_tpu/train/loop.py::Trainer without the
    scan dispatch).  ``state`` defaults to a fresh one from the scene's
    point cloud (subsampled to half the capacity, with
    ``np.random.default_rng(seed)``, when it holds more); it runs on
    ``device`` (cuda unless the caller asks for the CPU)."""

    def __init__(self, cfg: Config, scene, state: Optional[TrainState] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.scene = scene
        self.device = resolve_device(device)
        cam0 = scene.train_cameras[0]
        self.ctx = StepContext(cfg, cam0.width, cam0.height, device=self.device)
        if state is None:
            pc = scene.point_cloud
            pts, cols = pc.points, pc.colors
            cap = cfg.tpu.max_gaussians
            if len(pts) > cap:
                # leave headroom for densification; deterministic subsample
                keep = np.random.default_rng(seed).choice(len(pts), size=cap // 2,
                                                          replace=False)
                print(f"init cloud {len(pts)} > capacity {cap}: subsampling to {cap // 2}",
                      flush=True)
                pts, cols = pts[keep], cols[keep]
            state = init_state(cfg, pts, cols, seed=seed, device=self.device)
        self.state = state
        self.bg = np.array([1, 1, 1] if cfg.model.white_background else [0, 0, 0], np.float32)
        self.seed = seed
        self._batch_cache: Dict = {}
        self.metrics_history = []
        # tripwires (JAX's constants): checked every tripwire_every
        # iterations; the not-learning counters advance once per check
        self.tripwire_every = 25
        self._last_good_state: Optional[TrainState] = None
        self.thr_pin_eps = 0.005
        self.thr_pin_checks = 40
        self.psnr_flat_checks = 80
        self.mesh_psnr_floor = 18.0
        self.mesh_grace_iters = 1500
        self._thr_pinned_streak = 0
        self._psnr_low_streak = 0
        self._mesh_first_iter: Optional[int] = None
        eff_occ = min(cfg.model.grid_res, cfg.tpu.occ_res)
        if eff_occ < 256:
            print(f"[normal-init] occupancy grid at {eff_occ}^3 (reference: 256^3; raise "
                  f"tpu.occ_res to match it)", flush=True)

    def flags_for(self, it: int) -> StepFlags:
        return flags_for(self.cfg, it)

    def next_camera_idx(self, it: int) -> int:
        """Random-without-replacement camera order (reference
        train.py:146-151), from (seed, iteration) only, as JAX's: epochs of
        len(cameras) iterations, each an independent seeded permutation."""
        n = len(self.scene.train_cameras)
        epoch, pos = divmod(it - 1, n)
        perm = random.Random((self.seed << 32) ^ epoch).sample(range(n), n)
        return perm[pos]

    def next_camera(self, it: int):
        return self.scene.train_cameras[self.next_camera_idx(it)]

    def get_batch(self, cam) -> Batch:
        """The camera's batch on the device, made once per camera unless
        load2gpu_on_the_fly asks to stream it."""
        if self.cfg.model.load2gpu_on_the_fly:
            return make_batch(cam, self.scene.time_interval, self.bg, self.device)
        b = self._batch_cache.get(cam.uid)
        if b is None:
            b = make_batch(cam, self.scene.time_interval, self.bg, self.device)
            self._batch_cache[cam.uid] = b
        return b

    def generator(self, it: int) -> torch.Generator:
        """Iteration ``it``'s random stream, from (seed, it) only (JAX's
        fold_in(PRNGKey(seed), it)), on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(
            ((self.seed << 32) ^ it) & 0xFFFFFFFFFFFFFFFF)

    def run_iteration(self, it: int, draws: Optional[dict] = None):
        """Iteration ``it`` on its camera's batch (run_iteration above);
        ``draws`` as run_iteration's, else from ``generator(it)``.  Returns
        the metrics."""
        batch = self.get_batch(self.next_camera(it))
        self.state, metrics = run_iteration(self.ctx, self.state, batch, it,
                                            self.scene.cameras_extent,
                                            gen=self.generator(it), draws=draws)
        return metrics

    def save_debug_images(self, it: int, out_root: str):
        """Image and mesh dumps (reference train.py:323-386 → logs/, logs_geo/)."""
        from ..eval.testing import render_frame
        from ..utils_io import save_image, write_mesh_ply
        batch = self.get_batch(self.scene.train_cameras[0])
        step = int(self.state.step)
        mesh_on = step >= self.cfg.optimization.dpsr_iter
        out = render_frame(self.ctx, self.state, batch, min(step // 1000, self.cfg.model.sh_degree),
                           with_mesh=mesh_on)
        host = lambda x: x.clamp(0, 1).cpu().numpy()  # noqa: E731
        logs = os.path.join(out_root, "logs")
        save_image(os.path.join(logs, f"render_{it:06d}.png"), host(out["render"]).transpose(1, 2, 0))
        if mesh_on:
            save_image(os.path.join(logs, f"mesh_{it:06d}.png"),
                       host(out["mesh_image"]).transpose(1, 2, 0))
            save_image(os.path.join(logs, f"mask_{it:06d}.png"), host(out["mask"]))
            nv, nf = int(out["n_verts"]), int(out["n_faces"])
            write_mesh_ply(os.path.join(out_root, "logs_geo", f"mesh_{it:06d}.ply"),
                           out["verts"][:nv].cpu().numpy(), out["faces"][:nf].cpu().numpy())

    def _check_tripwires(self, it: int, metrics, save_dir: Optional[str]):
        """Halt on a non-finite loss, an empty mesh during the mesh phase,
        density_thres pinned at its bound, or a mesh PSNR flat below the
        floor after the grace window (JAX's four tripwires and constants).
        Saves the last-good and the tripped state.  The step is functional,
        so the last-good state is a plain reference."""
        loss = float(metrics["loss"])
        nv = metrics.get("mesh_n_verts")
        mesh_on = nv is not None
        bad = None
        if not np.isfinite(loss):
            bad = f"non-finite loss ({loss})"
        elif mesh_on and int(nv) == 0:
            bad = "empty mesh (mesh_n_verts == 0) during the mesh phase"
        if mesh_on and bad is None:
            if self._mesh_first_iter is None:
                self._mesh_first_iter = it
            thr = float(metrics.get("density_thres", 0.0))
            if abs(thr) >= DENSITY_THRES_BOUND - self.thr_pin_eps:
                self._thr_pinned_streak += 1
            else:
                self._thr_pinned_streak = 0
            mp = metrics.get("mesh_psnr")
            if mp is not None and it - self._mesh_first_iter >= self.mesh_grace_iters:
                self._psnr_low_streak = (self._psnr_low_streak + 1
                                         if float(mp) < self.mesh_psnr_floor else 0)
            if self._thr_pinned_streak >= self.thr_pin_checks:
                bad = (f"density_thres pinned at its +-{DENSITY_THRES_BOUND} projection bound "
                       f"for {self._thr_pinned_streak} consecutive checks "
                       f"(~{self._thr_pinned_streak * self.tripwire_every} iters): the mesh "
                       "phase is not learning")
            elif self._psnr_low_streak >= self.psnr_flat_checks:
                bad = (f"mesh_psnr below {self.mesh_psnr_floor} dB for "
                       f"{self._psnr_low_streak} consecutive checks "
                       f"(~{self._psnr_low_streak * self.tripwire_every} iters) after the "
                       f"{self.mesh_grace_iters}-iter grace window: the mesh phase is not "
                       "learning")
        if bad is None:
            self._last_good_state = self.state
            return
        from .checkpoint import save_checkpoint
        out = save_dir or (self.cfg.model.model_path or ".")
        if self._last_good_state is not None:
            save_checkpoint(self._last_good_state, out, int(self._last_good_state.step))
        save_checkpoint(self.state, out, it)
        diag = {k: float(v) for k, v in metrics.items()
                if not isinstance(v, torch.Tensor) or v.dim() == 0}
        raise TrainingHalted(f"TRIPWIRE at iter {it}: {bad}.\n  metrics: {diag}\n"
                             f"  last-good and tripped states checkpointed under {out}")

    def train(self, iterations: Optional[int] = None, log_every: int = 100,
              first_iter: int = 1, on_log=None, image_log_every: int = 0,
              image_log_dir: Optional[str] = None, save_at=(),
              save_dir: Optional[str] = None):
        """Iterations first_iter..iterations; every log_every (and the last)
        the metrics as floats go to ``metrics_history`` and ``on_log``, with
        JAX's console line; checkpoints at ``save_at``."""
        iterations = iterations or self.cfg.optimization.iterations
        save_at = set(save_at or ())
        window = time.time()
        for it in range(first_iter, iterations + 1):
            metrics = self.run_iteration(it)
            if it % self.tripwire_every == 0:
                self._check_tripwires(it, metrics, save_dir)
            if it % log_every == 0 or it == iterations:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - window
                window = time.time()
                m["iters_per_sec"] = log_every / dt if dt > 0 else 0.0
                m["iter"] = it
                self.metrics_history.append(m)
                print(log_line(it, m), flush=True)
                if on_log:
                    on_log(m)
            if image_log_every and image_log_dir and it % image_log_every == 0:
                self.save_debug_images(it, image_log_dir)
            if it in save_at and save_dir:
                from .checkpoint import save_checkpoint
                save_checkpoint(self.state, save_dir, it)
                print(f"[{it}] checkpoint saved", flush=True)
        return self.metrics_history


def log_line(it: int, m: dict) -> str:
    """JAX's console line for a logged iteration, with its mesh-overflow,
    non-finite-gradient and tile-K markers."""
    line = (f"[{it}] loss={m.get('loss', 0):.4f} psnr={m.get('img_psnr', 0):.2f} "
            + (f"mesh_psnr={m.get('mesh_psnr', 0):.2f} " if "mesh_psnr" in m else "")
            + f"alive={int(m.get('n_alive', 0))} it/s={m['iters_per_sec']:.2f}")
    if "psr_min" in m:
        line += (f" [V={int(m.get('mesh_n_verts', 0))} psr {m['psr_min']:.3f}.."
                 f"{m['psr_max']:.3f} thr={m.get('density_thres', 0):.4f} "
                 f"|n|={m.get('normal_norm', 0):.3f}]")
    if m.get("mesh_overflow", 0) > 0:
        line += (f"  !! MESH OVERFLOW {int(m['mesh_overflow'])} "
                 f"(V={int(m.get('mesh_n_verts', 0))}/F={int(m.get('mesh_n_faces', 0))} at "
                 "caps — raise max_verts/max_faces)")
    if m.get("nonfinite_grad_leaves", 0) > 0:
        line += f"  !! NONFINITE GRADS zeroed ({int(m['nonfinite_grad_leaves'])} leaves)"
    if (m.get("splat_overflow", 0) > 0 or m.get("raster_overflow", 0) > 0
            or m.get("splat_dup_overflow", 0) > 0):
        line += (f"  [tile-K ovf s={int(m.get('splat_overflow', 0))} "
                 f"r={int(m.get('raster_overflow', 0))}"
                 + (f" dup={int(m['splat_dup_overflow'])}"
                    if m.get("splat_dup_overflow", 0) > 0 else "")
                 + "]")
    return line
