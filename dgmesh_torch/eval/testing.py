"""Held-out evaluation: the inference render of a frame and the test pass.

Counterpart of dgmesh_tpu/eval/testing.py (reference train.py testing()
:559-760).  ``render_frame``, per test camera: deform MLPs → Gaussian
splat → DPSR → marching tets → deform-back + appearance MLPs → mesh
raster; the nets always apply in float32 (``ctx.f32()``), whatever the
training step's ``mlp_bf16``/``mlp_fused``, as in JAX.  ``run_testing``:
PSNR, SSIM and MS-SSIM (at 176 px and up) of the GS and mesh renders over
the test cameras, LPIPS (AlexNet and VGG, ``eval/lpips_torch.py``) for
each net whose converted weights are present, the images and meshes, and
fps.  ``export_dynamic_meshes``: the mesh sequence at uniform times that
the CD/EMD evaluation reads (cli/mesh_evaluation.py).
``pointcloud_scatter_render``: a matplotlib scatter of the Gaussians.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from ..config import Config
from ..models import gaussians as G
from ..ops import losses as L
from ..ops import mesh_raster as MR
from ..ops import splat
from ..train.step import StepContext, _deform_all, _mesh_colors, extract_mesh, make_batch
from ..utils_io import png_array, save_image, write_mesh_ply
from .lpips_torch import lpips_available, rgb_lpips


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


def pointcloud_scatter_render(points: np.ndarray, cam, out_path: str = None,
                              colors=None, s: float = 0.5):
    """Matplotlib scatter render of a Gaussian point cloud from a camera
    (dgmesh_tpu/eval/testing.py::pointcloud_scatter_render; the reference's
    utils/renderer.py pointcloud_renderer :322-374).  Returns (H,W,3) float
    in [0,1]; the figure's PNG is decoded by ``utils_io.png_array``.  Needs
    matplotlib, which it imports here."""
    import io

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts_h = np.concatenate([points, np.ones((len(points), 1))], 1)
    pv = pts_h @ cam.world_view.T
    ph = pts_h @ cam.full_proj.T
    ok = ph[:, 3] > 1e-6
    ndc = ph[ok, :2] / ph[ok, 3:4]
    fig = plt.figure(figsize=(cam.width / 100, cam.height / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    c = None if colors is None else np.clip(colors[ok], 0, 1)
    order = np.argsort(-pv[ok, 2])  # far first
    ax.scatter(ndc[order, 0], -ndc[order, 1], s=s, c=None if c is None else c[order])
    ax.set_xlim(-1, 1)
    ax.set_ylim(-1, 1)
    ax.axis("off")
    buf = io.BytesIO()
    fig.savefig(buf, format="png")
    plt.close(fig)
    img = png_array(buf.getvalue()).astype(np.float32)[..., :3] / 255.0
    if out_path:
        save_image(out_path, img)
    return img


@torch.no_grad()
def export_dynamic_meshes(cfg: Config, trainer, scene, out_dir: str, n_frames: int = 200):
    """Export the reconstructed mesh at ``n_frames`` uniform times
    ``fid = i / max(n_frames - 1, 1)`` as ``mesh_NNNNN.ply`` (the valid
    vertices with their colours, the valid faces): the deform and
    deform-normal nets on every slot at that time without noise, DPSR,
    marching tets and the vertex colours, the nets in float32 (reference
    train.py:389-423, the sequence the CD/EMD evaluation reads).  Returns
    each frame's ``n_verts``, ``n_faces`` and ``mesh_overflow`` (vertices
    or faces dropped at the caps: reported, not hidden)."""
    ctx = trainer.ctx.f32()     # exported meshes feed the CD/EMD eval: f32 nets
    gp, gs, nets = trainer.state.gp, trainer.state.gs, trainer.state.nets
    os.makedirs(out_dir, exist_ok=True)
    frames = []
    for i in range(n_frames):
        fid = torch.tensor(i / max(n_frames - 1, 1), dtype=torch.float32, device=ctx.device)
        d_xyz, _, _, d_normal = _deform_all(nets, gp.xyz, fid, True, mode=ctx.mlp_mode)
        m = extract_mesh(ctx, gp, gs, d_xyz, d_normal)
        color = _mesh_colors(nets, m.verts, m.vert_valid, fid, ctx.mlp_mode)
        nv, nf = int(m.n_verts), int(m.n_faces)
        write_mesh_ply(os.path.join(out_dir, f"mesh_{i:05d}.ply"), m.verts[:nv].cpu().numpy(),
                       m.faces[:nf].cpu().numpy(), color[:nv].cpu().numpy())
        frames.append(dict(n_verts=nv, n_faces=nf, mesh_overflow=int(m.overflow)))
    print(f"exported {n_frames} meshes to {out_dir}", flush=True)
    return frames


def write_test_results(results: Dict[str, float], out_dir: str) -> str:
    """``out_dir/test_result.txt``, one ``key: value`` line a metric of
    ``run_testing``'s results, as ``tools/make_quality_md.py`` reads it;
    returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "test_result.txt")
    with open(path, "w") as f:
        for k, v in results.items():
            f.write(f"{k}: {v}\n")
    return path


@torch.no_grad()
def run_testing(cfg: Config, trainer, scene, save_dir: str = None,
                with_mesh: bool = True) -> Dict[str, float]:
    """The test pass over ``scene.test_cameras`` with the trainer's state
    (dgmesh_tpu/eval/testing.py::run_testing): the mean psnr, ssim,
    ms_ssim and mesh_psnr, mesh_ssim, mesh_ms_ssim, lpips_<net> and
    mesh_lpips_<net> for each net whose LPIPS weights are present, and fps
    (renders per second of device-synchronised time, LPIPS not in it);
    with ``save_dir`` each view's render_NNN.png, mesh_NNN.png and
    mesh_NNN.ply."""
    ctx, state = trainer.ctx, trainer.state
    dev = ctx.device
    lpips_nets = [n for n in ("alex", "vgg") if lpips_available(n)]
    metrics = {k: [] for k in ("psnr", "ssim", "ms_ssim", "mesh_psnr", "mesh_ssim",
                               "mesh_ms_ssim")}
    for n in lpips_nets:
        metrics[f"lpips_{n}"] = []
        metrics[f"mesh_lpips_{n}"] = []
    t_total = 0.0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def score(prefix, img, gt):
        metrics[prefix + "psnr"].append(float(L.psnr(img, gt)))
        metrics[prefix + "ssim"].append(float(L.ssim(img, gt)))
        if img.shape[1] >= 176 and img.shape[2] >= 176:
            metrics[prefix + "ms_ssim"].append(float(L.ms_ssim(img, gt)))
        for n in lpips_nets:
            metrics[f"{prefix}lpips_{n}"].append(rgb_lpips(img, gt, n))

    for i, cam in enumerate(scene.test_cameras):
        batch = make_batch(cam, scene.time_interval, trainer.bg, dev)
        sync()
        t0 = time.time()
        out = render_frame(ctx, state, batch, cfg.model.sh_degree, with_mesh)
        sync()
        t_total += time.time() - t0
        img = out["render"].clamp(0, 1)
        score("", img, batch.gt_image)
        if with_mesh:
            score("mesh_", out["mesh_image"].clamp(0, 1), batch.gt_image)
        if save_dir:
            save_image(os.path.join(save_dir, f"render_{i:03d}.png"),
                       img.cpu().numpy().transpose(1, 2, 0))
            if with_mesh:
                save_image(os.path.join(save_dir, f"mesh_{i:03d}.png"),
                           out["mesh_image"].cpu().numpy().transpose(1, 2, 0))
                nv, nf = int(out["n_verts"]), int(out["n_faces"])
                write_mesh_ply(os.path.join(save_dir, f"mesh_{i:03d}.ply"),
                               out["verts"][:nv].cpu().numpy(), out["faces"][:nf].cpu().numpy(),
                               out["vtx_color"][:nv].cpu().numpy())
    result = {k: float(np.mean(v)) for k, v in metrics.items() if v}
    result["fps"] = len(scene.test_cameras) / t_total if t_total > 0 else 0.0
    return result
