"""Synthetic GT-mesh dataset generator (finetune-nerf layout).

The port's copy of dgmesh_tpu/data/synthetic_mesh.py, rendered by the
port's own mesh raster (kernel 3 on the card, its twin on the CPU): an
analytic deforming icosphere (watertight, genus 0) with an exactly known
surface at every time, RGBA frames of it (Blinn-Phong × a positional
albedo, vertex colours) from orbiting cameras, D-NeRF
transforms_{train,test}.json with a `time` per frame, a GT mesh per frame
in the finetune-nerf layout (`mesh/frame_<N>.ply`, reference
dataset_readers.py:355-453), optional .obj meshes at uniform times, and
noisy surface samples as the init cloud (points3d.ply).
``generate_capture_datasets`` renders the same scene through off-centre
pinhole cameras and writes it in the layouts of the real captures' readers
(Nerfies, iPhone, NeuralActor), masks as DEVA's palette PNGs or SAM's
greyscale ones.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from ..cameras import (Camera, camera_from_c2w_blender, fov2focal, gl_projection_from_K,
                       orbit_camera_poses)
from ..device import DeviceLike, resolve_device
from ..ops import mesh_raster as MR
from ..utils_io import write_mesh_ply, write_obj, write_png


def icosphere(subdiv: int = 5):
    """Unit icosphere by midpoint subdivision: 10242 verts / 20480 faces at
    subdiv=5.  Watertight by construction."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        vlist = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    return verts.astype(np.float32), faces.astype(np.int32)


def deform_icosphere(unit_verts: np.ndarray, t: float, base_r: float = 0.5):
    """Smooth, exactly known radial deformation of the unit sphere at time
    t ∈ [0,1]: breathing plus two rotating low-order lobes; radius ≤ ~0.66."""
    x, y, z = unit_verts[:, 0], unit_verts[:, 1], unit_verts[:, 2]
    w = 2 * math.pi * t
    r = base_r * (1.0
                  + 0.10 * math.sin(w)
                  + 0.14 * math.sin(w) * (z * z - 1.0 / 3.0) * 3.0 / 2.0
                  + 0.10 * math.cos(w) * (x * y) * 3.0)
    return (unit_verts * r[:, None]).astype(np.float32)


def albedo(unit_verts: np.ndarray):
    """Smooth positional albedo, so the appearance net has structure to fit."""
    v = unit_verts
    c = 0.5 + 0.5 * np.stack([
        np.sin(3.1 * v[:, 0] + 0.5),
        np.sin(2.7 * v[:, 1] + 2.1),
        np.sin(3.7 * v[:, 2] + 4.0)], -1)
    return (0.15 + 0.85 * c).astype(np.float32)


def write_points_ply(path: str, pts: np.ndarray, colors: np.ndarray):
    """xyz float + rgb uchar points (dgmesh_tpu/data/synthetic.py::_write_points_ply)."""
    n = len(pts)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
               "property float x", "property float y", "property float z",
               "property uchar red", "property uchar green", "property uchar blue",
               "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
        rec["xyz"] = pts
        rec["rgb"] = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
        f.write(rec.tobytes())


def _shader(unit_v, faces, dev):
    """shade(verts, camera centre) → the GT vertex colours: Blinn-Phong
    times the positional albedo."""
    col = albedo(unit_v)
    f_dev = torch.as_tensor(faces, dtype=torch.long, device=dev)
    f_valid = torch.ones(len(faces), dtype=torch.bool, device=dev)

    def shade(verts, cam_center):
        s = MR.phong_vertex_colors(torch.as_tensor(verts, device=dev), f_dev, f_valid,
                                   cam_center).cpu().numpy()
        return np.clip(s * col, 0, 1).astype(np.float32)
    return shade


@torch.no_grad()
def render_mesh_frame(verts, faces, vtx_color, cam, width, height, max_per_tile=256,
                      device: DeviceLike = None):
    """One GT frame: rgb (H,W,3) and coverage (H,W) in [0, 1], black
    background, back faces culled (exact for the hard image and mask of a
    closed, outward-wound mesh).  Fails on a per-tile capacity overflow."""
    dev = resolve_device(device)
    cfg = MR.MeshRasterConfig(width=width, height=height, max_per_tile=max_per_tile,
                              max_dup=1 << 20, cull_backface=True)
    f32 = dict(dtype=torch.float32, device=dev)
    f = torch.as_tensor(faces, dtype=torch.long, device=dev)
    out = MR.render_mesh(torch.as_tensor(verts, **f32), f,
                         torch.ones(f.shape[0], dtype=torch.bool, device=dev),
                         torch.as_tensor(vtx_color, **f32), torch.as_tensor(cam.mesh_pose(), **f32),
                         torch.as_tensor(gl_projection_from_K(cam.intrinsics, width, height),
                                         **f32),
                         torch.zeros(3, **f32), cfg, want_soft=False)
    ovf = int(out["aux"]["tile_overflow"])
    if ovf:
        raise RuntimeError(f"GT frame: {ovf} faces over max_per_tile={max_per_tile}")
    return (out["rgb"].clamp(0, 1).cpu().numpy(), out["mask"].clamp(0, 1).cpu().numpy())


def generate_mesh_dataset(out_dir: str, n_frames: int = 40, width: int = 800,
                          height: int = 800, n_test: int = 8, subdiv: int = 5,
                          fovx: float = 0.8, radius: float = 2.8,
                          n_eval_meshes: int = 0, seed: int = 0,
                          max_per_tile: int = 256, device: DeviceLike = None):
    """Write the finetune-nerf-layout dataset under out_dir:
      transforms_{train,test}.json  (D-NeRF, `time` per frame)
      train/r_<N>.png, test/r_<N>.png   (RGBA, alpha = coverage)
      mesh/frame_<N>.ply, mesh_test/frame_<N>.ply   (GT mesh per frame)
      gt_eval/frame_<NNNNN>.obj   (GT at n_eval_meshes uniform times)
      points3d.ply                 (noisy surface samples, an SfM-like init)
    Frames render on ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    unit_v, faces = icosphere(subdiv)
    os.makedirs(out_dir, exist_ok=True)
    shade = _shader(unit_v, faces, dev)

    def make_split(split, n, mesh_dir, pose_offset=0.0):
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        os.makedirs(os.path.join(out_dir, mesh_dir), exist_ok=True)
        poses = orbit_camera_poses(n, radius=radius, elevation=0.35 + pose_offset)
        frames = []
        for i in range(n):
            t = i / max(n - 1, 1)
            verts = deform_icosphere(unit_v, t)
            cam = camera_from_c2w_blender(i, poses[i], fovx, width, height, t)
            cam_center = poses[i][:3, 3].astype(np.float32)
            rgb, alpha = render_mesh_frame(verts, faces, shade(verts, cam_center), cam,
                                           width, height, max_per_tile, dev)
            rgba = np.concatenate([rgb, alpha[..., None]], -1)
            fname = f"{split}/r_{i:03d}"
            write_png(os.path.join(out_dir, fname + ".png"), (rgba * 255).astype(np.uint8))
            write_mesh_ply(os.path.join(out_dir, mesh_dir, f"frame_{i}.ply"), verts, faces)
            frames.append(dict(file_path=fname, time=t, transform_matrix=poses[i].tolist()))
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=fovx, frames=frames), f)

    make_split("train", n_frames, "mesh")
    make_split("test", n_test, "mesh_test", pose_offset=0.15)
    if n_eval_meshes:
        gdir = os.path.join(out_dir, "gt_eval")
        os.makedirs(gdir, exist_ok=True)
        for i in range(n_eval_meshes):
            t = i / max(n_eval_meshes - 1, 1)
            write_obj(os.path.join(gdir, f"frame_{i:05d}.obj"), deform_icosphere(unit_v, t),
                      faces)
    # noisy GT-surface samples as the SfM-like init cloud
    rng = np.random.default_rng(1)
    v0 = deform_icosphere(unit_v, 0.0)
    pick = rng.integers(0, len(v0), 20_000)
    pts = v0[pick] + rng.normal(scale=0.02, size=(len(pick), 3)).astype(np.float32)
    write_points_ply(os.path.join(out_dir, "points3d.ply"), pts.astype(np.float32),
                     albedo(unit_v)[pick])


# DEVA's Annotations: palette PNGs, index 0 the background (black), 1 the object
DEVA_PALETTE = np.array([[0, 0, 0], [128, 0, 0]], np.uint8)
NERFIES_RATIO = 0.5                              # rgb/2x: half the cameras' resolution
SCENE_CENTER, SCENE_SCALE = np.array([0.1, -0.2, 0.3]), 0.5   # Nerfies' scene.json


def generate_capture_datasets(out_root: str, n_train: int = 8, n_val: int = 2,
                              width: int = 540, height: int = 960, subdiv: int = 5,
                              max_per_tile: int = 256, device: DeviceLike = None) -> dict:
    """Render the deforming icosphere at ``n_train + n_val`` times through
    orbiting pinhole cameras (width × height; one focal length for a
    horizontal field of view of 0.7 rad; the principal point at (0.52 W,
    0.48 H)) and write the frames in the Nerfies, iPhone and NeuralActor
    layouts under out_root/<layout>; returns {layout: path}.  Frame i is at
    time i / (n - 1); every (n / n_val)-th frame, from the middle of the
    first stride, is a validation frame.  The training world is the GT
    mesh's frame; each layout stores it as its reader expects:

      Nerfies: camera/<id>.json (OpenCV w2c rotation as ``orientation``,
        camera centre as ``position``, focal length and principal point at
        the full resolution, 1 / NERFIES_RATIO times the frames'), positions
        and points.npy in raw coordinates (world / SCENE_SCALE +
        SCENE_CENTER, undone by scene.json), rgb/2x and DEVA palette masks
        under mask-tracking/2x/Annotations, dataset.json, metadata.json
        (time_id);
      iPhone: the same at ratio 1 in world coordinates, SAM-style
        greyscale masks (0 / 255), metadata.json with warp_id only;
      NeuralActor: transforms_{train,test}.json (OpenCV c2w, a per-frame
        ``intrinsic``, ``time``), training/cam00/*.png and
        training_mask/Annotations/cam00/*.png (testing/ for the val frames),
        palette masks.
    Frames render on ``device`` (cuda unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    unit_v, faces = icosphere(subdiv)
    shade = _shader(unit_v, faces, dev)
    n = n_train + n_val
    stride = n // max(n_val, 1)
    val = {stride // 2 + k * stride for k in range(n_val)}
    ids = [f"{i:05d}" for i in range(n)]
    frames = []
    focal = fov2focal(0.7, width)
    K = np.array([[focal, 0, 0.52 * width], [0, focal, 0.48 * height], [0, 0, 1]], np.float32)
    for i, c2w_bl in enumerate(orbit_camera_poses(n, radius=2.8, elevation=0.35)):
        t = i / max(n - 1, 1)
        c2w = c2w_bl.astype(np.float64)
        c2w[:3, 1:3] *= -1                       # Blender → OpenCV axes
        w2c = np.linalg.inv(c2w)
        cam = Camera(uid=i, R=w2c[:3, :3].T, T=w2c[:3, 3], fovx=0.0, fovy=0.0, image=None,
                     alpha_mask=None, fid=t, width=width, height=height, K=K,
                     orig_transform=c2w_bl)
        verts = deform_icosphere(unit_v, t)
        rgb, cover = render_mesh_frame(verts, faces, shade(verts, c2w[:3, 3].astype(np.float32)),
                                       cam, width, height, max_per_tile, dev)
        frames.append(dict(id=ids[i], time=t, c2w=c2w, K=K, val=i in val,
                           rgb=(rgb * 255).astype(np.uint8), mask=cover > 0.5))
    rng = np.random.default_rng(1)
    v0 = deform_icosphere(unit_v, 0.0)
    pts = (v0[rng.integers(0, len(v0), 20_000)]
           + rng.normal(scale=0.02, size=(20_000, 3))).astype(np.float64)
    train_ids = [f["id"] for f in frames if not f["val"]]
    val_ids = [f["id"] for f in frames if f["val"]]
    out = {}
    for layout in ("Nerfies", "iPhone", "NeuralActor"):
        root = os.path.join(out_root, layout)
        os.makedirs(root, exist_ok=True)
        out[layout] = root
        if layout == "NeuralActor":
            for split, sub in (("train", "training"), ("test", "testing")):
                recs = []
                for f in frames:
                    if f["val"] != (split == "test"):
                        continue
                    rel = f"{sub}/cam00/{f['id']}.png"
                    write_png(os.path.join(root, rel), f["rgb"])
                    write_png(os.path.join(root, f"{sub}_mask/Annotations/cam00/{f['id']}.png"),
                              f["mask"].astype(np.uint8), palette=DEVA_PALETTE)
                    recs.append(dict(file_path=rel, time=f["time"], intrinsic=f["K"].tolist(),
                                     transform_matrix=f["c2w"].tolist()))
                with open(os.path.join(root, f"transforms_{split}.json"), "w") as fh:
                    json.dump(dict(frames=recs), fh)
            continue
        nerfies = layout == "Nerfies"
        ratio = NERFIES_RATIO if nerfies else 1.0
        sub = f"{int(1 / ratio)}x"
        to_raw = (lambda x: x / SCENE_SCALE + SCENE_CENTER) if nerfies else (lambda x: x)
        for f in frames:
            w2c = np.linalg.inv(f["c2w"])
            K = f["K"].astype(np.float64)
            cam_json = dict(orientation=w2c[:3, :3].tolist(),
                            position=to_raw(f["c2w"][:3, 3]).tolist(),
                            focal_length=K[0, 0] / ratio,
                            principal_point=(K[:2, 2] / ratio).tolist(),
                            image_size=[round(width / ratio), round(height / ratio)])
            os.makedirs(os.path.join(root, "camera"), exist_ok=True)
            with open(os.path.join(root, "camera", f["id"] + ".json"), "w") as fh:
                json.dump(cam_json, fh)
            write_png(os.path.join(root, "rgb", sub, f["id"] + ".png"), f["rgb"])
            mask_path = os.path.join(root, "mask-tracking", sub, "Annotations", f["id"] + ".png")
            if nerfies:
                write_png(mask_path, f["mask"].astype(np.uint8), palette=DEVA_PALETTE)
            else:
                write_png(mask_path, f["mask"].astype(np.uint8) * 255)
        meta = {f["id"]: (dict(time_id=i, warp_id=i) if nerfies else dict(warp_id=i))
                for i, f in enumerate(frames)}
        for name, obj in (("metadata.json", meta),
                          ("dataset.json", dict(train_ids=train_ids, val_ids=val_ids))):
            with open(os.path.join(root, name), "w") as fh:
                json.dump(obj, fh)
        if nerfies:
            with open(os.path.join(root, "scene.json"), "w") as fh:
                json.dump(dict(center=SCENE_CENTER.tolist(), scale=SCENE_SCALE), fh)
        np.save(os.path.join(root, "points.npy"), to_raw(pts))
    return out
