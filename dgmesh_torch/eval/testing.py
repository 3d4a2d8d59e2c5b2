"""Inference render of one frame: the port's entry point.

Counterpart of dgmesh_tpu/eval/testing.py::render_frame (reference train.py
testing() :559-760, per test camera): deform MLPs → Gaussian splat → DPSR →
marching tets → deform-back + appearance MLPs → mesh raster.  The nets
always apply in float32 (``ctx.f32()``), whatever the training step's
``mlp_bf16``/``mlp_fused``, as in JAX.
"""

from __future__ import annotations

import torch

from ..models import gaussians as G
from ..ops import mesh_raster as MR
from ..ops import splat
from ..train.step import StepContext, _deform_all, _mesh_colors, extract_mesh


@torch.no_grad()
def render_frame_with_aux(ctx: StepContext, state, batch, sh_degree: int,
                          with_mesh: bool = True):
    """``render_frame`` plus the capacity counters of the pass:
    ``splat_overflow``, ``splat_dup_overflow``, ``mesh_overflow``,
    ``raster_overflow`` (0-d tensors)."""
    ctx = ctx.f32()     # eval path: the nets apply in float32
    gp, gs, nets = state.gp, state.gs, state.nets
    d_xyz, d_rot, d_scale, d_normal = _deform_all(nets, gp.xyz, batch.fid, with_mesh,
                                                  mode=ctx.mlp_mode)
    out = splat.render(gp.xyz + d_xyz, G.get_scaling(gp) + d_scale,
                       G.get_rotation(gp) + d_rot, G.get_opacity(gp),
                       G.get_features(gp), gs.alive, batch.cam, batch.bg,
                       ctx.splat_cfg, sh_degree=sh_degree)
    res = dict(render=out["render"])
    aux = dict(splat_overflow=out["aux"]["tile_overflow"],
               splat_dup_overflow=out["aux"]["dup_overflow"])
    if with_mesh:
        mesh = extract_mesh(ctx, gp, gs, d_xyz, d_normal)
        vtx_color = _mesh_colors(nets, mesh.verts, mesh.vert_valid, batch.fid, ctx.mlp_mode)
        mout = MR.render_mesh(mesh.verts, mesh.faces, mesh.face_valid, vtx_color,
                              batch.mesh_pose, batch.mesh_proj, batch.bg,
                              ctx.mr_cfg, want_soft=False)
        res.update(mesh_image=mout["rgb"].permute(2, 0, 1), mask=mout["mask"],
                   verts=mesh.verts, faces=mesh.faces,
                   n_verts=mesh.n_verts, n_faces=mesh.n_faces,
                   vtx_color=vtx_color)
        aux.update(mesh_overflow=mesh.overflow,
                   raster_overflow=mout["aux"]["tile_overflow"])
    return res, aux


def render_frame(ctx: StepContext, state, batch, sh_degree: int,
                 with_mesh: bool = True):
    """One inference render: a dict with the GS image ``render`` (3,H,W) and,
    with ``with_mesh``, ``mesh_image`` (3,H,W), ``mask`` (H,W), the padded
    ``verts``/``faces``, ``n_verts``/``n_faces`` and ``vtx_color``."""
    return render_frame_with_aux(ctx, state, batch, sh_degree, with_mesh)[0]
