"""Scene orchestration: dataset dispatch, camera shuffling, extent.

The port's copy of dgmesh_tpu/data/scene.py (reference scene/__init__.py
Scene :25-141): the dataset type from the config's ``data_type`` or sniffed
from the folder, each reader's arguments, the resolution policy (Pillow's
LANCZOS resize through data/resize.py, ``K`` scaled with the image), the
seeded shuffle of the training cameras (``random.Random(seed)``, as JAX's),
and the cameras' extent from the NeRF++ normalisation.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np

from ..cameras import Camera
from ..config import Config
from .readers import SCENE_READERS, SceneInfo
from .resize import lanczos_resize


def apply_resolution_policy(cams: List, resolution: int) -> List:
    """The reference's loadCam policy (utils/camera_utils.py:23-63):
    resolution 1 (or None) keeps the native size; -1 keeps it up to 1600
    wide and otherwise scales to 1600 (printing the reference's notice once);
    any other positive value divides the size by it, rounded.  A resized
    image and mask are quantised to uint8 by truncation and LANCZOS-resized
    as Pillow does; ``K``'s first two rows scale by new width / width."""
    out = []
    warned = False
    for cam in cams:
        w = cam.width
        if resolution in (1, -1, None) and (resolution != -1 or w <= 1600):
            out.append(cam)
            continue
        if resolution == -1:
            if not warned:
                print("[INFO] big images detected: auto-downscaling to 1.6K. "
                      "Use --resolution 1 to keep native size.")
                warned = True
            scale = w / 1600.0
        elif resolution > 0:
            scale = float(resolution)
        else:
            out.append(cam)
            continue
        nw, nh = round(w / scale), round(cam.height / scale)

        def rz(img):
            if img is None:
                return None
            res = lanczos_resize((np.clip(img, 0, 1) * 255).astype(np.uint8).squeeze(),
                                 (nw, nh)).astype(np.float32) / 255.0
            return res[..., None] if res.ndim == 2 else res

        K = None
        if cam.K is not None:
            K = cam.K.copy()
            K[:2] *= nw / w
        out.append(Camera(
            uid=cam.uid, R=cam.R, T=cam.T, fovx=cam.fovx, fovy=cam.fovy,
            image=rz(cam.image), alpha_mask=rz(cam.alpha_mask), fid=cam.fid, width=nw,
            height=nh, image_name=cam.image_name, K=K, orig_transform=cam.orig_transform))
    return out


def detect_scene_type(path: str, data_type: str = "") -> str:
    if data_type:
        mapping = {"Nerfies": "nerfies", "iPhone": "iPhone",
                   "NeuralActor": "NeuralActor", "finetune-nerf": "finetune-nerf"}
        return mapping.get(data_type, data_type)
    if os.path.exists(os.path.join(path, "sparse")):
        return "Colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "Blender"
    if os.path.exists(os.path.join(path, "cameras_sphere.npz")):
        return "DTU"
    if os.path.exists(os.path.join(path, "poses_bounds.npy")):
        return "PlenopticVideo"
    if os.path.exists(os.path.join(path, "dataset.json")):
        return "nerfies"
    raise ValueError(f"Could not infer scene type for {path}")


class Scene:
    def __init__(self, cfg: Config, shuffle: bool = True, seed: int = 0,
                 max_frames: Optional[int] = None):
        self.cfg = cfg
        path = cfg.model.source_path
        stype = detect_scene_type(path, cfg.model.data_type)
        m = cfg.model
        # each reader's arguments (reference scene/__init__.py:47-85)
        if stype == "Blender":
            kwargs = dict(white_background=m.white_background, max_frames=max_frames,
                          downsample=m.downsample)
        elif stype == "Colmap":
            kwargs = dict(images=m.images, white_background=m.white_background,
                          eval_split=m.eval)
        elif stype == "nerfies":
            kwargs = dict(white_background=m.white_background, eval_split=m.eval,
                          nerfies_ratio=m.nerfies_ratio)
        elif stype in ("iPhone", "NeuralActor"):
            kwargs = dict(white_background=m.white_background, eval_split=m.eval)
        elif stype == "finetune-nerf":
            kwargs = dict(white_background=m.white_background, eval_split=m.eval,
                          downsample=m.downsample, mesh_path=m.pretrain_mesh_path or None,
                          mesh_path_test=m.pretrain_mesh_path_test or None,
                          max_frames=max_frames)
        else:                                      # DTU, PlenopticVideo: their defaults
            kwargs = {}
        self.info: SceneInfo = SCENE_READERS[stype](path, **kwargs)
        if m.resolution not in (1, None):
            self.info.train_cameras[:] = apply_resolution_policy(self.info.train_cameras,
                                                                 m.resolution)
            self.info.test_cameras[:] = apply_resolution_policy(self.info.test_cameras,
                                                                m.resolution)
        if shuffle:
            random.Random(seed).shuffle(self.info.train_cameras)   # scene/__init__.py:102-104
        self.cameras_extent = self.info.nerf_normalization["radius"]

    @property
    def train_cameras(self):
        return self.info.train_cameras

    @property
    def test_cameras(self):
        return self.info.test_cameras

    @property
    def point_cloud(self):
        return self.info.point_cloud

    @property
    def time_interval(self) -> float:
        return 1.0 / max(len(self.info.train_cameras), 1)
