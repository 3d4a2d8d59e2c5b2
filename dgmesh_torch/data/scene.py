"""Scene orchestration: dataset dispatch, camera shuffling, extent.

The port's copy of dgmesh_tpu/data/scene.py (reference scene/__init__.py
Scene :25-141): the dataset type from the config's ``data_type`` or sniffed
from the folder, the reader's arguments, the seeded shuffle of the training
cameras (``random.Random(seed)``, as JAX's), and the cameras' extent from
the NeRF++ normalisation.  Only the readers of data/readers.py are here;
a resolution policy that would resize the images raises (the LANCZOS
resize is not ported yet).
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

from ..config import Config
from .readers import SCENE_READERS, SceneInfo


def apply_resolution_policy(cams: List, resolution: int) -> List:
    """The reference's loadCam policy (utils/camera_utils.py:23-63) where it
    keeps the native size: resolution 1, or -1 on images at most 1600 wide.
    Any other case resizes and raises."""
    for cam in cams:
        if not (resolution in (1, -1, None) and (resolution != -1 or cam.width <= 1600)):
            raise NotImplementedError(
                f"resolution {resolution} resizes {cam.width}x{cam.height} images with the "
                "reference's LANCZOS filter, which the port has not ported yet")
    return cams


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
        if stype not in SCENE_READERS:
            raise NotImplementedError(f"the {stype} reader is not ported yet (the port reads "
                                      f"{', '.join(SCENE_READERS)})")
        m = cfg.model
        if stype == "Blender":                     # reference scene/__init__.py:47-85
            kwargs = dict(white_background=m.white_background, max_frames=max_frames,
                          downsample=m.downsample)
        else:
            kwargs = dict(white_background=m.white_background, eval_split=m.eval,
                          downsample=m.downsample, mesh_path=m.pretrain_mesh_path or None,
                          mesh_path_test=m.pretrain_mesh_path_test or None,
                          max_frames=max_frames)
        self.info: SceneInfo = SCENE_READERS[stype](path, **kwargs)
        if cfg.model.resolution not in (1, None):
            apply_resolution_policy(self.info.train_cameras, cfg.model.resolution)
            apply_resolution_policy(self.info.test_cameras, cfg.model.resolution)
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
