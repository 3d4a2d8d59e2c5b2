"""The pieces of the training step that the render path runs.

Counterpart of dgmesh_tpu/train/step.py (``StepContext``, ``Batch``,
``_deform_all``, ``extract_mesh``, ``_mesh_colors``) and of
dgmesh_tpu/train/loop.py::make_batch.  Float32 only, and only what the render
path reads: ``StepFlags``, ``mlp_bf16``, the losses, the backward pass and
Adam come with training.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import Camera, gl_projection_from_K
from ..config import Config
from ..device import DeviceLike, resolve_device
from ..models import gaussians as G
from ..ops import mesh_raster as MR
from ..ops import splat
from ..ops.dpsr import DPSR
from ..ops.marching_tets import MTConfig, marching_tets

SMALL = 1e-6


class Batch(NamedTuple):
    cam: splat.CameraArrays
    mesh_pose: torch.Tensor      # (4,4) blender-GL w2c
    mesh_proj: torch.Tensor      # (4,4) GL projection
    gt_image: torch.Tensor       # (3,H,W)
    gt_mask: torch.Tensor        # (H,W)
    fid: torch.Tensor            # ()
    time_interval: torch.Tensor  # ()
    bg: torch.Tensor             # (3,)


def make_batch(cam: Camera, time_interval: float, bg: np.ndarray,
               device: DeviceLike = None) -> Batch:
    """Host camera → device batch (dgmesh_tpu/train/loop.py::make_batch)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    if cam.image is not None:
        gt = torch.as_tensor(np.transpose(cam.image, (2, 0, 1)), **f32)
    else:
        gt = torch.zeros((3, cam.height, cam.width), **f32)
    mask = (cam.alpha_mask[..., 0] if cam.alpha_mask is not None
            else np.ones((cam.height, cam.width), np.float32))
    return Batch(
        cam=splat.CameraArrays.from_camera(cam, dev),
        mesh_pose=torch.as_tensor(cam.mesh_pose(), **f32),
        mesh_proj=torch.as_tensor(gl_projection_from_K(cam.intrinsics, cam.width,
                                                       cam.height), **f32),
        gt_image=gt,
        gt_mask=torch.as_tensor(mask, **f32),
        fid=torch.tensor(cam.fid, **f32),
        time_interval=torch.tensor(time_interval, **f32),
        bg=torch.as_tensor(bg, **f32),
    )


class StepContext:
    """Static pieces shared by the step variants: shapes, operators, configs."""

    def __init__(self, cfg: Config, width: int, height: int, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        t = cfg.tpu
        self.splat_cfg = splat.SplatConfig(
            width=width, height=height, tile_h=t.tile_h, tile_w=t.tile_w,
            max_per_tile=t.max_gaussians_per_tile, max_dup=t.max_dup)
        self.mr_cfg = MR.MeshRasterConfig(
            width=width, height=height, tile_h=t.tile_h, tile_w=t.tile_w,
            max_per_tile=t.max_faces_per_tile, max_dup=t.max_face_dup,
            sigma=t.mask_sigma, cull_backface=t.mr_cull_backface)
        self.mt_cfg = MTConfig(res=cfg.model.grid_res, max_verts=t.max_verts,
                               max_faces=t.max_faces,
                               max_cubes=max(t.max_verts, t.max_faces // 2))
        self.dpsr = DPSR((cfg.model.grid_res,) * 3, sig=cfg.optimization.dpsr_sig,
                         div_mode="splat" if t.dpsr_div_splat else "spectral",
                         device=self.device)


def _deform_all(nets, xyz, fid, with_normal: bool):
    """Forward deformation offsets (reference train.py:154-175); the normal
    offset only with ``with_normal``, else zeros."""
    M = xyz.shape[0]
    t_in = torch.full((M, 1), float(fid), dtype=xyz.dtype, device=xyz.device)
    xyz_sg = xyz.detach()
    d_xyz, d_rot, d_scale, _ = nets.deform(xyz_sg, t_in)
    if with_normal:
        d_normal = nets.deform_normal(xyz_sg, t_in)
    else:
        d_normal = xyz.new_zeros((M, 3))
    return d_xyz, d_rot, d_scale, d_normal


def extract_mesh(ctx: StepContext, gp: G.GaussianParams, gs: G.GaussianStats,
                 d_xyz, d_normal):
    """DPSR → marching tets → world-space mesh (reference renderer.py:150-175)."""
    pts = gp.xyz + d_xyz
    p01 = (pts - gs.gaussian_center) / gs.gaussian_scale / 2.0 + 0.5
    p01 = p01.clamp(SMALL, 1.0 - SMALL)
    normals = gp.normal + d_normal
    psr = ctx.dpsr(p01, normals, gs.alive)
    sign = torch.sign(psr[0, 0, 0].detach())
    sign = torch.where(sign == 0, 1.0, sign)
    psr = psr * sign - gp.density_thres
    m = marching_tets(psr, ctx.mt_cfg)
    verts_w = (m.verts * 2.0 - 1.0) * gs.gaussian_scale + gs.gaussian_center
    verts_w = torch.where(m.vert_valid[:, None], verts_w, 0.0)
    return m._replace(verts=verts_w)


def _mesh_colors(nets, verts_w, vert_valid, fid):
    """deform_back to canonical + appearance colours (renderer.py:177-181).

    Valid vertices are a prefix of the padded buffer; only they go through
    the nets (the JAX version runs every padded row and zeroes the rest —
    the same result)."""
    n = int(vert_valid.sum())
    v = verts_w[:n]
    t_in = torch.full((n, 1), float(fid), dtype=v.dtype, device=v.device)
    d_back, _, _, _ = nets.deform_back(v.detach(), t_in)
    color = verts_w.new_zeros((verts_w.shape[0], 3))
    color[:n] = nets.appearance(v + d_back, t_in)
    return color
