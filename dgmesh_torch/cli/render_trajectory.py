"""Orbit-trajectory rendering CLI (reference dgmesh/render_trajectory.py
:43-174; the port's copy of dgmesh_tpu/cli/render_trajectory.py).

    python -m dgmesh_torch.cli.render_trajectory -m OUT [--n_views 60] [--device cuda]

Loads the checkpoint (the latest, or --iteration) and the config the run
stored, as ``cli.render_test`` does, and renders a turntable of the
dynamic mesh: at each of ``--n_views`` orbit poses, at time i/(n-1), the
textured mesh render (``render_frame``: kernels 1 and 3) beside the
Blinn-Phong shape render (``render_mesh_shape``: kernel 3 once more),
saved as frame_NNN.png; then trajectory.gif where imageio is installed.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch


def trajectory_cameras(cam0, n_views: int, radius: float, elevation: float) -> List:
    """The orbit's cameras, with ``cam0``'s field of view and size, at times
    i / max(n_views - 1, 1)."""
    from ..cameras import camera_from_c2w_blender, orbit_camera_poses
    poses = orbit_camera_poses(n_views, radius=radius, elevation=elevation)
    return [camera_from_c2w_blender(i, poses[i], cam0.fovx, cam0.width, cam0.height,
                                    i / max(n_views - 1, 1),
                                    image=np.zeros((cam0.height, cam0.width, 3), np.float32))
            for i in range(n_views)]


@torch.no_grad()
def render_panel(trainer, batch, cam_center) -> np.ndarray:
    """mesh render | shape render of one view, (H, 2W, 3) float in [0,1]."""
    from ..eval.testing import render_frame
    from ..ops import mesh_raster as MR
    out = render_frame(trainer.ctx, trainer.state, batch, trainer.cfg.model.sh_degree, True)
    mesh_img = out["mesh_image"].clamp(0, 1).permute(1, 2, 0)
    faces = out["faces"]
    fvalid = torch.arange(faces.shape[0], device=faces.device) < out["n_faces"]
    shape = MR.render_mesh_shape(out["verts"], faces, fvalid, batch.mesh_pose, batch.mesh_proj,
                                 cam_center, trainer.ctx.mr_cfg)["rgb"].clamp(0, 1)
    return torch.cat([mesh_img, shape], dim=1).cpu().numpy()


def main(argv=None, device: Optional[str] = None):
    """Render the orbit of a trained model; ``device`` overrides --device.
    Returns the panels."""
    from ..config import Config, add_config_args, config_from_args
    from ..data.scene import Scene
    from ..device import resolve_device
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import Trainer
    from ..train.step import make_batch
    from ..utils_io import save_image

    parser = argparse.ArgumentParser(description="dgmesh_torch orbit renders")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--n_views", type=int, default=60)
    parser.add_argument("--radius", type=float, default=3.0)
    parser.add_argument("--elevation", type=float, default=0.3)
    parser.add_argument("--out", type=str, default=None)
    add_config_args(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(device or args.device)
    cfg = config_from_args(args, args.config)
    stored = os.path.join(cfg.model.model_path, "cfg_args.json")
    if os.path.exists(stored):
        base = Config.load(stored)
        base.model.model_path = cfg.model.model_path
        cfg = base
    scene = Scene(cfg, shuffle=False)
    state = load_checkpoint(cfg, cfg.model.model_path, args.iteration, device=dev)
    trainer = Trainer(cfg, scene, state=state, device=dev)
    out_dir = args.out or os.path.join(cfg.model.model_path, "trajectory")
    os.makedirs(out_dir, exist_ok=True)

    panels = []
    for i, cam in enumerate(trajectory_cameras(scene.train_cameras[0], args.n_views,
                                               args.radius, args.elevation)):
        batch = make_batch(cam, scene.time_interval, trainer.bg, dev)
        panel = render_panel(trainer, batch, cam.camera_center)
        save_image(os.path.join(out_dir, f"frame_{i:03d}.png"), panel)
        panels.append(panel)
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        print(f"gif export skipped: {e}", flush=True)
    else:
        imageio.mimsave(os.path.join(out_dir, "trajectory.gif"),
                        [(p * 255).astype(np.uint8) for p in panels], fps=15)
    print(f"wrote {len(panels)} frames to {out_dir}", flush=True)
    return panels


if __name__ == "__main__":
    main()
