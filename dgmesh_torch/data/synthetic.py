"""Synthetic D-NeRF-format dataset generator.

The port's copy of dgmesh_tpu/data/synthetic.py: the ground truth of a
procedural dynamic Gaussian scene (a coloured sphere-shell blob that
squashes and stretches in time), rendered by the port's own splat renderer
(kernel 1 on the card, its twin on the CPU), written as a D-NeRF dataset
(transforms_{train,test}.json and RGBA PNGs) with an SfM-like
points3d.ply, so that it drives the Blender reader and the whole training
stack.  Its random draws are numpy's ``default_rng(seed)``, as JAX's are,
so both packages draw the same scene and cloud.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..cameras import camera_from_c2w_blender, orbit_camera_poses
from ..device import DeviceLike, resolve_device
from ..utils_io import write_png
from .synthetic_mesh import write_points_ply


def gt_gaussian_scene(n: int = 2000, seed: int = 0):
    """A coloured sphere-shell blob with a time-dependent squash."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = 0.45 + 0.05 * rng.random(n)
    base = d * r[:, None]
    colors = 0.5 + 0.5 * np.stack([d[:, 0], d[:, 1], d[:, 2]], -1)
    scales = np.full((n, 3), 0.04, np.float32)
    opac = np.full(n, 0.85, np.float32)

    def at_time(t):
        squash = 1.0 + 0.25 * math.sin(2 * math.pi * t)
        pts = base.copy()
        pts[:, 2] *= squash
        pts[:, 0] /= math.sqrt(squash)
        pts[:, 1] /= math.sqrt(squash)
        return pts.astype(np.float32)

    return dict(base=base.astype(np.float32), colors=colors.astype(np.float32),
                scales=scales, opacity=opac, at_time=at_time)


@torch.no_grad()
def render_gt_frame(scene, cam, width, height, device: DeviceLike = None):
    """One GT frame: rgb (H,W,3) and alpha (H,W) in [0, 1], by the splat
    renderer at SH degree 0 on a black background."""
    from ..ops import splat
    from ..ops.sh import rgb_to_sh

    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    n = scene["pts"].shape[0]
    quats = torch.zeros((n, 4), **f32)
    quats[:, 0] = 1
    cfg = splat.SplatConfig(width=width, height=height, max_per_tile=512, max_dup=1 << 18)
    out = splat.render(torch.as_tensor(scene["pts"], **f32),
                       torch.as_tensor(scene["scales"], **f32), quats,
                       torch.as_tensor(scene["opacity"], **f32),
                       rgb_to_sh(torch.as_tensor(scene["colors"], **f32))[:, None, :],
                       torch.ones(n, dtype=torch.bool, device=dev),
                       splat.CameraArrays.from_camera(cam, dev), torch.zeros(3, **f32), cfg,
                       sh_degree=0)
    rgb = out["render"].permute(1, 2, 0).cpu().numpy()
    return np.clip(rgb, 0, 1), np.clip(out["alpha"].cpu().numpy(), 0, 1)


def generate_dataset(out_dir: str, n_frames: int = 20, width: int = 128,
                     height: int = 128, n_gaussians: int = 2000,
                     fovx: float = 0.9, radius: float = 2.8,
                     n_test: int = 4, seed: int = 0, device: DeviceLike = None):
    """Write a D-NeRF-format dataset under out_dir; returns the scene dict.
    Frames render on ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    g = gt_gaussian_scene(n_gaussians, seed)
    os.makedirs(os.path.join(out_dir, "train"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "test"), exist_ok=True)

    def make_split(split, n, pose_offset=0.0):
        poses = orbit_camera_poses(n, radius=radius, elevation=0.35 + pose_offset)
        frames = []
        for i in range(n):
            t = i / max(n - 1, 1)
            cam = camera_from_c2w_blender(i, poses[i], fovx, width, height, t)
            rgb, alpha = render_gt_frame(
                dict(pts=g["at_time"](t), colors=g["colors"], scales=g["scales"],
                     opacity=g["opacity"]), cam, width, height, dev)
            rgba = np.concatenate([rgb, alpha[..., None]], -1)
            fname = f"{split}/r_{i:03d}"
            write_png(os.path.join(out_dir, fname + ".png"), (rgba * 255).astype(np.uint8))
            frames.append(dict(file_path=fname, time=t, transform_matrix=poses[i].tolist()))
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=fovx, frames=frames), f)

    make_split("train", n_frames)
    make_split("test", n_test, pose_offset=0.15)
    # a seed point cloud near the object (like SfM points), read through the
    # reader's points3d.ply path
    rng = np.random.default_rng(seed + 1)
    n_pts = min(4 * n_gaussians, 20_000)
    d = rng.normal(size=(n_pts, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * (0.4 + 0.15 * rng.random((n_pts, 1)))
    write_points_ply(os.path.join(out_dir, "points3d.ply"), pts.astype(np.float32),
                     rng.random((n_pts, 3)).astype(np.float32))
    return g
