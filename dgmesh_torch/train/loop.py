"""The training iteration around the step: phase flags and the structural ops.

Counterpart of the iteration body of dgmesh_tpu/train/loop.py::Trainer
(reference train.py training() :129-530): ``flags_for`` picks the static
phase gates of an iteration, ``anchor_fn`` is the loop's anchor step
(``Trainer._anchor_fn``), and ``run_iteration`` is
``Trainer.run_iteration`` without the camera choice: the caller passes the
iteration's batch.  The trainer itself (camera order, tripwires,
checkpoints, logging) and JAX's scan dispatch are not here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from .densify import anchor_step, densify_and_prune, normal_initialization, reset_opacity
from .state import TrainState
from .step import Batch, StepContext, StepFlags, _deform_all, extract_mesh, train_step


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
