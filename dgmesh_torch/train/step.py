"""The training step: the mesh-phase iteration, its losses, backward and Adam.

Counterpart of dgmesh_tpu/train/step.py (``StepFlags``, ``StepContext``,
``Batch``, ``_deform_all``, ``extract_mesh``, ``_mesh_colors``,
``loss_and_aux``, ``train_step``) and of dgmesh_tpu/train/loop.py::make_batch
(reference train.py:129-530): deform → GS splat → cycle consistency → DPSR →
marching tets → mesh render → mask / mesh-image / Laplacian losses → the
anchor loss (on anchor iterations) → GS image loss → one backward → masked
Gaussian Adam and per-net Adam.  Phase gates are ``StepFlags``.  The nets
run in ``StepContext.mlp_mode``: float32, bf16 (``mlp_bf16``) or the fused
bf16 trunk kernels (``mlp_bf16`` and ``mlp_fused``); the render path, the
anchoring and the normal init apply them in float32 (``StepContext.f32``).
The structural ops themselves (densify/prune, opacity reset, normal init,
anchoring) are train/densify.py's, run around the step by train/loop.py.

With ``StepContext(device_mesh=...)`` (a parallel/sharding.py mesh) the step
runs on one rank of n, the state that rank's part (``shard_state``): the
splat goes through parallel/sharded_splat.py; the DPSR through
parallel/sharded_dpsr.py where ``div_mode`` is "splat" and the grid divides
by n; the marching tets through parallel/sharded_mt.py where the grid
divides by n; the mesh raster through parallel/sharded_mr.py where the face
capacity does (JAX's conditions, dgmesh_tpu/train/step.py:181-320).  What
GSPMD inserts in JAX is explicit here: the cycle-loss means from numerators
and counts summed over the ranks, the image losses on the gathered images,
the Laplacian on the stitched mesh, the backward seeded with 1/n (every
rank computes the whole loss), the nets' and ``density_thres``' gradients
summed over the ranks before Adam, the non-finite test of a leaf taken over
all its rows; the Gaussian Adam runs on the rank's own rows.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..cameras import Camera, gl_projection_from_K
from ..config import Config
from ..device import DeviceLike, resolve_device
from ..models import gaussians as G
from ..ops import losses as L
from ..ops import mesh_raster as MR
from ..ops import splat
from ..ops.dpsr import DPSR
from ..ops.laplacian import laplacian_uniform_tri
from ..ops.marching_tets import MTConfig, marching_tets
from ..parallel.sharded_dpsr import dpsr_sharded
from ..parallel.sharded_mr import render_mesh_sharded
from ..parallel.sharded_mt import marching_tets_sharded, stitch
from ..parallel.sharded_splat import render_sharded
from ..parallel.sharding import (all_gather, pmin, psum, replicated_backward_scale,
                                 rows_of)
from ..schedules import linear_noise
from .state import (NetParams, TrainState, gaussian_adam_update, gaussian_group_lrs,
                    net_adam_update, net_lrs)

SMALL = 1e-6


class StepFlags(NamedTuple):
    """Static phase gates (dgmesh_tpu/train/step.py StepFlags, reference
    train.py:127-304)."""
    warm: bool = False                  # iter < warm_up: no deformation
    mesh: bool = False                  # iter >= dpsr_iter: the mesh branch
    freeze_pos: bool = False            # iter < dpsr_iter + normal_warm_up
    use_normal: bool = False            # iter >= dpsr_iter + 2000
    anchor: bool = False                # every anchor_interval after anchor_iter: the anchor loss
    skip_gaussian_update: bool = False  # densify/anchor iterations
    densify_stats: bool = True
    sh_degree: int = 3


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


def mlp_mode(cfg: Config) -> str:
    """The nets' arithmetic from the config, as JAX's build_nets reads it
    (dgmesh_tpu/train/state.py:69-70): fused only together with bf16."""
    t = cfg.tpu
    if t.mlp_bf16:
        return "fused" if t.mlp_fused else "bf16"
    return "f32"


class StepContext:
    """Static pieces shared by the step variants: shapes, operators, configs,
    and ``mlp_mode``, the arithmetic of the training step's nets.

    ``device_mesh``: a parallel/sharding.py ``DeviceMesh``; the step then
    runs as that mesh's rank on its part of the state (module docstring).
    The padded Gaussian capacity must divide by the number of ranks."""

    def __init__(self, cfg: Config, width: int, height: int, device: DeviceLike = None,
                 device_mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mlp_mode = mlp_mode(cfg)
        self._f32_view = None
        self.device_mesh = device_mesh
        t = cfg.tpu
        if device_mesh is not None and t.max_gaussians % device_mesh.world:
            raise ValueError(
                f"tpu.max_gaussians={t.max_gaussians} is not divisible by the "
                f"{device_mesh.world}-rank mesh; pick a multiple of {device_mesh.world} "
                "(the sharded splat splits the padded Gaussian axis)")
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

    def f32(self) -> "StepContext":
        """A shallow view whose nets apply in float32, for the render path
        (the per-phase precision policy of dgmesh_tpu/train/step.py:117-143).
        Cached; ``self`` when the nets already are float32."""
        if self.mlp_mode == "f32":
            return self
        if self._f32_view is None:
            v = copy.copy(self)
            v.mlp_mode = "f32"
            v._f32_view = v
            self._f32_view = v
        return self._f32_view


def _time_input(fid: torch.Tensor, noise, rows: int, like: torch.Tensor) -> torch.Tensor:
    """The (rows,1) time column fid + noise, on the device, without a sync."""
    t = fid.to(device=like.device, dtype=like.dtype) + noise
    return t.reshape(1, 1).expand(rows, 1)


def _deform_all(nets, xyz, fid, with_normal: bool, warm: bool = False, noise=0.0,
                mode: str = "f32"):
    """Forward deformation offsets (reference train.py:154-175), the nets in
    ``mode``: zeros when ``warm``; the normal offset only with
    ``with_normal``, else zeros."""
    M = xyz.shape[0]
    if warm:
        z3 = xyz.new_zeros((M, 3))
        return z3, xyz.new_zeros((M, 4)), z3, z3
    t_in = _time_input(fid, noise, M, xyz)
    xyz_sg = xyz.detach()
    d_xyz, d_rot, d_scale, _ = nets.deform(xyz_sg, t_in, mode)
    if with_normal:
        d_normal = nets.deform_normal(xyz_sg, t_in, mode)
    else:
        d_normal = xyz.new_zeros((M, 3))
    return d_xyz, d_rot, d_scale, d_normal


def extract_mesh(ctx: StepContext, gp: G.GaussianParams, gs: G.GaussianStats,
                 d_xyz, d_normal, freeze_pos: bool = False, with_diag: bool = False):
    """DPSR → marching tets → world-space mesh (reference renderer.py:150-175).

    ``freeze_pos`` stops the gradient into the point positions.  With
    ``with_diag``, also the field-health scalars (psr range, corner level,
    mean live normal length, density_thres), without gradient."""
    pts = gp.xyz + d_xyz
    if freeze_pos:
        pts = pts.detach()
    p01 = (pts - gs.gaussian_center) / gs.gaussian_scale / 2.0 + 0.5
    # jnp.clip's gradient at a bound: half, as minimum/maximum split ties
    # (torch.clamp would pass all of it)
    p01 = torch.minimum(torch.maximum(p01, p01.new_tensor(SMALL)), p01.new_tensor(1.0 - SMALL))
    normals = gp.normal + d_normal
    dm = ctx.device_mesh
    if dm is None:
        psr = ctx.dpsr(p01, normals, gs.alive)
    elif ctx.dpsr.div_mode == "splat" and ctx.dpsr.res[0] % dm.world == 0:
        psr = dpsr_sharded(dm, ctx.dpsr, p01, normals, gs.alive)
    else:
        psr = ctx.dpsr(all_gather(p01, dm), all_gather(normals, dm), all_gather(gs.alive, dm))
    sign = torch.sign(psr[0, 0, 0].detach())
    sign = torch.where(sign == 0, 1.0, sign)
    psr = psr * sign - gp.density_thres
    if dm is not None and ctx.mt_cfg.res % dm.world == 0:
        # the rank's block of the mesh (parallel/sharded_mt.py's layout)
        m = marching_tets_sharded(dm, psr, ctx.mt_cfg)
    else:
        m = marching_tets(psr, ctx.mt_cfg)
    verts_w = (m.verts * 2.0 - 1.0) * gs.gaussian_scale + gs.gaussian_center
    verts_w = torch.where(m.vert_valid[:, None], verts_w, 0.0)
    m = m._replace(verts=verts_w)
    if not with_diag:
        return m
    with torch.no_grad():
        alive_n = _sum(gs.alive.sum(), dm).clamp_min(1)
        norm_sum = torch.where(gs.alive, torch.linalg.norm(normals, dim=-1), 0.0).sum()
        diag = dict(psr_min=psr.min(), psr_max=psr.max(), psr_corner=psr[0, 0, 0].clone(),
                    normal_norm=_sum(norm_sum, dm) / alive_n,
                    density_thres=gp.density_thres.clone())
    return m, diag


def _sum(x: torch.Tensor, dm) -> torch.Tensor:
    """x summed over the ranks (x itself on one device)."""
    return x if dm is None else psum(x, dm)


def _mesh_colors(nets, verts_w, vert_valid, fid, mode: str = "f32"):
    """deform_back to canonical + appearance colours (renderer.py:177-181),
    the nets in ``mode``.

    Valid vertices are a prefix of the padded buffer; only they go through
    the nets (the JAX version runs every padded row and zeroes the rest —
    the same result)."""
    n = int(vert_valid.sum())
    v = verts_w[:n]
    t_in = _time_input(fid, 0.0, n, v)
    d_back, _, _, _ = nets.deform_back(v.detach(), t_in, mode)
    color = verts_w.new_zeros((verts_w.shape[0], 3))
    color[:n] = nets.appearance(v + d_back, t_in, mode)
    return color


def _normal_draws(gen: Optional[torch.Generator]) -> torch.Tensor:
    """Two standard-normal draws from ``gen`` (torch's default CPU
    generator when None)."""
    return torch.randn((2,), generator=gen, device="cpu" if gen is None else gen.device)


def _time_noise(ctx: StepContext, batch: Batch, step_f, gen: Optional[torch.Generator]):
    """The two cycle time-noise draws (train.py:160-162, 200-202): the
    deformation's and the cycle's; none for blender data, as in every
    shipped synthetic config."""
    if ctx.cfg.model.is_blender:
        return 0.0, 0.0
    mag = batch.time_interval * linear_noise(step_f)
    z = _normal_draws(gen).to(mag.device)
    return z[0] * mag, z[1] * mag


def loss_and_aux(ctx: StepContext, gp: G.GaussianParams, nets: NetParams, screen_offset,
                 gs: G.GaussianStats, batch: Batch, step_f, flags: StepFlags,
                 gen: Optional[torch.Generator] = None, anchor_info=None):
    """Total loss (reference train.py:193-321) and aux: the stop-gradient loss
    terms under ``losses``, the splat's radii and visibility, the capacity
    counters, the PSNRs, the mesh size and the field-health scalars.  With
    ``flags.anchor``, ``anchor_info`` (train/densify.py::AnchorInfo, from
    this iteration's anchor step) gives the anchor loss."""
    cfg = ctx.cfg
    o = cfg.optimization
    M = gp.xyz.shape[0]
    aux: Dict[str, torch.Tensor] = {}
    losses: Dict[str, torch.Tensor] = {}
    noise1, noise2 = _time_noise(ctx, batch, step_f, gen)

    mode = ctx.mlp_mode
    dm = ctx.device_mesh
    d_xyz, d_rot, d_scale, d_normal = _deform_all(nets, gp.xyz, batch.fid, flags.use_normal,
                                                  flags.warm, noise1, mode)

    # --- Gaussian splat render (gaussian_renderer/__init__.py:32-119)
    means3d = gp.xyz + d_xyz
    render = (splat.render if dm is None
              else lambda *a, **k: render_sharded(dm, *a, **k))
    out = render(means3d, G.get_scaling(gp) + d_scale, G.get_rotation(gp) + d_rot,
                 G.get_opacity(gp), G.get_features(gp), gs.alive, batch.cam,
                 batch.bg, ctx.splat_cfg, sh_degree=flags.sh_degree,
                 screen_offset=screen_offset)
    image = out["render"]
    aux["radii"] = out["radii"].detach()
    aux["visibility"] = out["visibility"]
    aux["splat_overflow"] = out["aux"]["tile_overflow"]
    aux["splat_dup_overflow"] = out["aux"]["dup_overflow"]

    # --- cycle consistency (train.py:198-240)
    if not flags.warm:
        M_t = _time_input(batch.fid, noise2, M, gp.xyz)
        d_back, d_rot_back, d_scale_back, _ = nets.deform_back(means3d.detach(), M_t, mode)
        n_live = _sum(gs.alive.sum(), dm)

        def masked_l1(a, b):
            # |diff| with jnp.abs's gradient, +1 at 0 (JAX's cycle loss;
            # torch.abs gives 0 there): on the first non-warm iteration the
            # zero-initialised heads make every diff exactly 0
            diff = torch.where(gs.alive[:, None], a - b, 0.0)
            num = _sum(torch.where(diff >= 0, diff, -diff).sum(), dm)
            return num / (n_live * a.shape[-1]).clamp_min(1)

        cyc = [masked_l1(-d_back, d_xyz), masked_l1(-d_rot_back, d_rot),
               masked_l1(-d_scale_back, d_scale)]
        if flags.use_normal:
            d_normal_back = nets.deform_back_normal(gp.xyz.detach(), M_t, mode)
            cyc.append(masked_l1(-d_normal_back, d_normal))
        losses["cycle_loss"] = sum(cyc[1:], cyc[0]) / float(len(cyc))

    # --- mesh branch (train.py:248-285)
    if flags.mesh:
        mesh, mesh_diag = extract_mesh(ctx, gp, gs, d_xyz, d_normal, flags.freeze_pos,
                                       with_diag=True)
        aux.update(mesh_diag)
        if dm is None:
            vtx_color = _mesh_colors(nets, mesh.verts, mesh.vert_valid, batch.fid, mode)
            # one verts[faces] gather shared by the raster and the Laplacian,
            # of the valid faces (a prefix) only: the padding faces all point
            # at vertex 0, and their gather's backward would pile on it
            tri_w = _valid_corners(mesh.verts, mesh.faces, mesh.face_valid)
            mout = MR.render_mesh(mesh.verts, mesh.faces, mesh.face_valid, vtx_color,
                                  batch.mesh_pose, batch.mesh_proj, batch.bg, ctx.mr_cfg,
                                  want_soft=True, tri_w=tri_w)
        else:
            mesh, tri_w, vtx_color, mout = _mesh_render_sharded(ctx, nets, mesh, batch, mode)
        # straight-through mask: the hard coverage value, the soft gradient
        mask = mout["st_mask"]
        mesh_image = mout["rgb"].permute(2, 0, 1)
        losses["mask_loss"] = L.l1_loss(mask, batch.gt_mask) * 100.0 * o.mask_loss_weight
        losses["mesh_img_loss"] = (L.image_loss(mesh_image, batch.gt_image, o.lambda_dssim)
                                   * o.mesh_img_loss_weight)
        t_iter = step_f / o.iterations
        losses["laplacian_loss"] = (
            laplacian_uniform_tri(tri_w, mesh.verts, mesh.faces, mesh.face_valid)
            * 1000.0 * cfg.model.laplacian_loss_weight * (1.0 - t_iter))
        aux["mesh_psnr"] = L.psnr(mesh_image.detach(), batch.gt_image)
        aux["mesh_overflow"] = mesh.overflow
        aux["mesh_n_verts"] = mesh.n_verts
        aux["mesh_n_faces"] = mesh.n_faces
        aux["raster_overflow"] = mout["aux"]["tile_overflow"]

    # --- anchor loss (train.py:287-304): the 1-1 term is differentiable
    # through means3d (into the deform net and xyz); the n-1 term is a
    # constant, as tests/test_anchor_gradient_parity.py pins
    if flags.anchor and anchor_info is not None:
        # with a device mesh, anchor_info holds the rank's rows
        w = anchor_info.gauss_1_1_mask
        d2 = ((means3d - anchor_info.centroid_of_gaussian) ** 2).sum(-1)
        a11 = _sum(torch.where(w, d2, 0.0).sum(), dm) / _sum(w.sum(), dm).clamp_min(1)
        losses["anchor_loss"] = (a11 + anchor_info.loss_n_1) * 0.1

    # --- GS image loss (train.py:306-312)
    losses["img_loss"] = L.image_loss(image, batch.gt_image, o.lambda_dssim)
    aux["img_psnr"] = L.psnr(image.detach(), batch.gt_image)

    total = image.new_zeros(())
    for v in losses.values():
        total = total + v
    aux["losses"] = {k: v.detach() for k, v in losses.items()}
    return total, aux


def _valid_corners(verts, faces, face_valid):
    """verts[faces] (F,3,3) of the valid faces, zeros elsewhere."""
    idx = torch.nonzero(face_valid).squeeze(1)
    tri_w = verts.new_zeros(faces.shape + (3,))
    tri_w[idx] = verts[faces[idx]]
    return tri_w


def _mesh_render_sharded(ctx: StepContext, nets, mesh, batch: Batch, mode: str):
    """The mesh colours and render on one rank of ``ctx.device_mesh``.

    ``mesh`` is the rank's block where the marching tets ran sharded (its
    colours are computed there and gathered), else the whole mesh (coloured
    whole on every rank).  The raster takes the rank's block of the face
    axis where the face capacity divides by n, else renders whole.  Returns
    the whole mesh, its valid faces' corners (for the Laplacian), the
    vertex colours and the render."""
    dm = ctx.device_mesh
    blocked = ctx.mt_cfg.res % dm.world == 0
    vtx_color = _mesh_colors(nets, mesh.verts, mesh.vert_valid, batch.fid, mode)
    block = mesh
    if blocked:
        vtx_color = all_gather(vtx_color, dm)
        mesh = stitch(mesh, dm)
    tri_w = _valid_corners(mesh.verts, mesh.faces, mesh.face_valid)
    args = (batch.mesh_pose, batch.mesh_proj, batch.bg, ctx.mr_cfg)
    if blocked or mesh.faces.shape[0] % dm.world == 0:
        faces, fvalid = ((block.faces, block.face_valid) if blocked
                         else (rows_of(mesh.faces, dm), rows_of(mesh.face_valid, dm)))
        mout = render_mesh_sharded(dm, mesh.verts, faces, fvalid, vtx_color, *args,
                                   want_soft=True,
                                   tri_w=_valid_corners(mesh.verts, faces, fvalid))
    else:
        mout = MR.render_mesh(mesh.verts, mesh.faces, mesh.face_valid, vtx_color, *args,
                              want_soft=True, tri_w=tri_w)
    return mesh, tri_w, vtx_color, mout


class Grads(NamedTuple):
    gp: G.GaussianParams            # one per Gaussian leaf
    nets: NetParams                 # per net, one per tensor of net.parameters()
    screen: torch.Tensor            # (M,2) view-space (screen_offset) gradient


def backward(loss: torch.Tensor, gp: G.GaussianParams, nets: NetParams,
             screen: torch.Tensor) -> Grads:
    """d loss / d every Gaussian leaf, net parameter and the screen offset;
    zeros for a leaf the loss does not reach (as JAX's grad gives)."""
    params = [list(n.parameters()) for n in nets]
    inputs = list(gp) + [screen] + [p for ps in params for p in ps]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    n = len(gp)
    g_nets, i = [], n + 1
    for ps in params:
        g_nets.append(grads[i:i + len(ps)])
        i += len(ps)
    return Grads(gp=G.GaussianParams(*grads[:n]), nets=NetParams(*g_nets), screen=grads[n])


def loss_and_grads(ctx: StepContext, state: TrainState, batch: Batch, flags: StepFlags,
                   gen: Optional[torch.Generator] = None, anchor_info=None):
    """The forward (``loss_and_aux``) and the backward of one step, from
    ``state`` (which is not modified).  Returns (loss, aux, Grads).  With a
    device mesh, the rank's gradients: its own rows', and its part of the
    replicated leaves' (``sanitize`` sums those)."""
    M = state.gp.xyz.shape[0]
    gp = G.GaussianParams(*[x.detach().requires_grad_(True) for x in state.gp])
    screen = state.gp.xyz.new_zeros((M, 2), requires_grad=True)
    loss, aux = loss_and_aux(ctx, gp, state.nets, screen, state.gs, batch,
                             state.step.to(torch.float32), flags, gen, anchor_info)
    seed = replicated_backward_scale(ctx.device_mesh)
    return loss.detach(), aux, backward(loss * seed if seed != 1.0 else loss, gp, state.nets,
                                        screen)


def sanitize(grads: Grads, device_mesh=None):
    """Zero every gradient leaf that holds a non-finite value, and count them
    (JAX's sanitiser, dgmesh_tpu/train/step.py:410-431).  No host sync.

    With a device mesh, the replicated leaves' gradients (the nets',
    ``density_thres``') are first summed over the ranks, and a row leaf is
    non-finite where any rank's rows are."""
    n = len(grads.gp)
    leaves = list(grads.gp) + [g for net in grads.nets for g in net]
    if device_mesh is not None:
        dt = G.GaussianParams._fields.index("density_thres")
        leaves = [psum(g, device_mesh) if i >= n or i == dt else g
                  for i, g in enumerate(leaves)]
    ok = torch.stack([torch.isfinite(g).all() for g in leaves])
    if device_mesh is not None:
        ok = pmin(ok.to(torch.int32), device_mesh).bool()
    bad = (~ok).sum().to(torch.int32)
    clean = [torch.where(o, g, 0.0) for o, g in zip(ok, leaves)]
    gp = G.GaussianParams(*clean[:n])
    nets, i = [], n
    for g in grads.nets:
        nets.append(clean[i:i + len(g)])
        i += len(g)
    return grads._replace(gp=gp, nets=NetParams(*nets)), bad


def apply_updates(ctx: StepContext, state: TrainState, aux, grads: Grads,
                  flags: StepFlags) -> TrainState:
    """The densify statistics (train.py:489-496) and the optimizer steps:
    masked Gaussian Adam (unless ``skip_gaussian_update``) and Adam on each
    net that the phase trains (train_step :443-457); an inactive net keeps
    its parameters and moments.  Returns the new state."""
    gs = state.gs
    if flags.densify_stats:
        vis = aux["visibility"] & gs.alive
        gs = gs._replace(
            max_radii2d=torch.where(vis, torch.maximum(gs.max_radii2d, aux["radii"]),
                                    gs.max_radii2d),
            xyz_grad_accum=gs.xyz_grad_accum + torch.where(
                vis, torch.linalg.norm(grads.screen, dim=-1), 0.0),
            denom=gs.denom + vis.to(gs.denom.dtype))
    step_f = state.step.to(torch.float32)
    if flags.skip_gaussian_update:
        gp, g_mu, g_nu, g_count = state.gp, state.g_mu, state.g_nu, state.g_count
    else:
        gp, g_mu, g_nu, g_count = gaussian_adam_update(
            state.gp, grads.gp, state.g_mu, state.g_nu, state.g_count,
            gaussian_group_lrs(state.step, ctx.cfg), gs.alive)
    nlrs = net_lrs(step_f, ctx.cfg)
    active = dict(deform=not flags.warm, deform_normal=flags.use_normal,
                  deform_back=not flags.warm, deform_back_normal=flags.use_normal,
                  appearance=flags.mesh)
    nets, opts = [], []
    for name in NetParams._fields:
        net, opt = getattr(state.nets, name), getattr(state.net_opt, name)
        if active[name]:
            net, opt = net_adam_update(net, getattr(grads.nets, name), opt,
                                       getattr(nlrs, name))
        nets.append(net)
        opts.append(opt)
    return TrainState(gp=gp, gs=gs, nets=NetParams(*nets), g_mu=g_mu, g_nu=g_nu,
                      g_count=g_count, net_opt=NetParams(*opts), step=state.step + 1)


METRIC_KEYS = ("mesh_psnr", "mesh_overflow", "splat_overflow", "splat_dup_overflow",
               "raster_overflow", "mesh_n_verts", "mesh_n_faces", "psr_min", "psr_max",
               "psr_corner", "normal_norm", "density_thres")


def train_step(ctx: StepContext, state: TrainState, batch: Batch, flags: StepFlags,
               gen: Optional[torch.Generator] = None, anchor_info=None):
    """One optimisation step (dgmesh_tpu/train/step.py::train_step); returns
    (new_state, metrics).  ``state`` is not modified, so a step can be taken
    again from it; ``gen`` draws the time noise of non-blender data;
    ``anchor_info`` feeds the anchor loss on an anchor iteration.  With
    ``ctx.device_mesh``, every rank calls it with its part of the state
    (parallel/sharding.py::shard_state) and gets its part of the new state;
    the metrics are global."""
    loss, aux, grads = loss_and_grads(ctx, state, batch, flags, gen, anchor_info)
    grads, nonfinite = sanitize(grads, ctx.device_mesh)
    new_state = apply_updates(ctx, state, aux, grads, flags)
    metrics = dict(loss=loss, **aux["losses"], img_psnr=aux["img_psnr"],
                   n_alive=_sum(new_state.gs.alive.sum(), ctx.device_mesh),
                   nonfinite_grad_leaves=nonfinite)
    metrics.update({k: aux[k] for k in METRIC_KEYS if k in aux})
    return new_state, metrics
