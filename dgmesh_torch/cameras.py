"""Camera model and projection math (host side, numpy float32).

A copy of what the render path needs from ``dgmesh_tpu/cameras.py``; the
conventions are the reference's:
  - ``world_view`` W2V = [[Rᵀ, t],[0,1]] (reference utils/graphics_utils.py:34-52);
  - ``projection`` is the 3DGS perspective matrix with z_sign=+1
    (graphics_utils.py:56-100); ``full_proj`` = projection @ world_view;
  - the mesh rasterizer takes an OpenGL w2c pose (``Camera.mesh_pose``) and
    an OpenGL projection from the intrinsics (``gl_projection_from_K``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

ZNEAR = 0.01
ZFAR = 100.0

# reference: nvdiffrast_utils/util.py:470-482
BLENDER2OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float32
)
OPENCV2BLENDER = BLENDER2OPENCV.copy()  # involution


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """reference: graphics_utils.py getWorld2View2 :41-52."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = (C2W[:3, 3] + translate) * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """reference: graphics_utils.py getProjectionMatrix :56-77 (z_sign=+1)."""
    th_y = math.tan(fovy / 2)
    th_x = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / th_x
    P[1, 1] = 1.0 / th_y
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def projection_matrix_from_K(znear: float, zfar: float, K: np.ndarray,
                             W: int, H: int) -> np.ndarray:
    """reference: graphics_utils.py getProjectionMatrix_from_K :79-100."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    top = znear * cy / fy
    bottom = -znear * (H - cy) / fy
    right = znear * (W - cx) / fx
    left = -znear * cx / fx
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = -(right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def gl_projection_from_K(K: np.ndarray, W: int, H: int,
                         znear: float = 0.1, zfar: float = 1000.0) -> np.ndarray:
    """OpenGL projection from intrinsics (reference nvdiffrast_utils/util.py
    K_to_projection :484-490): camera space (-z forward) → clip space, y up."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2 * fx / W
    P[0, 2] = 1.0 - 2.0 * cx / W
    P[1, 1] = 2 * fy / H
    P[1, 2] = 2.0 * cy / H - 1.0
    P[2, 2] = -(zfar + znear) / (zfar - znear)
    P[2, 3] = -2.0 * zfar * znear / (zfar - znear)
    P[3, 2] = -1.0
    return P


@dataclass
class Camera:
    """Host-side camera record (reference: scene/cameras.py:18-85)."""

    uid: int
    R: np.ndarray                 # (3,3) cam-to-world rotation
    T: np.ndarray                 # (3,) world-to-cam translation
    fovx: float
    fovy: float
    image: Optional[np.ndarray]   # (H,W,3) float32 in [0,1]
    alpha_mask: Optional[np.ndarray]  # (H,W,1) float32 or None
    fid: float                    # normalized time in [0,1]
    width: int
    height: int
    image_name: str = ""
    K: Optional[np.ndarray] = None            # (3,3) pinhole intrinsics, optional
    orig_transform: Optional[np.ndarray] = None  # (4,4) c2w blender/OpenGL pose
    # per-frame GT mesh (finetune-nerf format, reference dataset_readers.py:404-409)
    mesh_verts: Optional[np.ndarray] = None
    mesh_faces: Optional[np.ndarray] = None
    znear: float = ZNEAR
    zfar: float = ZFAR
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3, dtype=np.float32))
    scale: float = 1.0

    @property
    def world_view(self) -> np.ndarray:
        return world_to_view(self.R, self.T, self.trans, self.scale)

    @property
    def projection(self) -> np.ndarray:
        if self.K is not None:
            return projection_matrix_from_K(self.znear, self.zfar, self.K,
                                            self.width, self.height)
        return projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)

    @property
    def full_proj(self) -> np.ndarray:
        return (self.projection @ self.world_view).astype(np.float32)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view)[:3, 3].astype(np.float32)

    @property
    def intrinsics(self) -> np.ndarray:
        """Pinhole K (derived from FoV if not given); reference utils/renderer.py:186-201."""
        if self.K is not None:
            return np.asarray(self.K, dtype=np.float32)
        fx = fov2focal(self.fovx, self.width)
        fy = fov2focal(self.fovy, self.height)
        return np.array(
            [[fx, 0, self.width / 2], [0, fy, self.height / 2], [0, 0, 1]],
            dtype=np.float32,
        )

    def mesh_pose(self) -> np.ndarray:
        """World→camera pose for the mesh rasterizer, OpenGL convention
        (reference utils/renderer.py:203-208)."""
        if self.orig_transform is not None:
            c2w_blender = np.asarray(self.orig_transform, dtype=np.float32)
        else:
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :3] = self.R.T
            w2c[:3, 3] = self.T
            c2w_blender = np.linalg.inv(w2c) @ BLENDER2OPENCV
        c2w_opencv = c2w_blender @ BLENDER2OPENCV
        w2c_blender = OPENCV2BLENDER @ np.linalg.inv(c2w_opencv)
        return w2c_blender.astype(np.float32)


def orbit_camera_poses(n: int, radius: float = 3.0, elevation: float = 0.0,
                       height: float = 0.0) -> np.ndarray:
    """Turntable c2w poses (blender convention, looking at the origin);
    reference utils/camera_utils.py get_camera_trajectory_pose :121-148."""
    poses = []
    for az in np.linspace(0, 2 * np.pi, n, endpoint=False):
        eye = np.array([radius * np.cos(az),
                        radius * np.sin(az),
                        radius * np.sin(elevation) + height])
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(forward, up)
        right /= np.linalg.norm(right) + 1e-12
        true_up = np.cross(right, forward)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0] = right
        c2w[:3, 1] = true_up
        c2w[:3, 2] = -forward
        c2w[:3, 3] = eye
        poses.append(c2w)
    return np.stack(poses)


def camera_from_c2w_blender(uid: int, c2w_blender: np.ndarray, fovx: float,
                            width: int, height: int, fid: float,
                            image: Optional[np.ndarray] = None,
                            alpha_mask: Optional[np.ndarray] = None,
                            image_name: str = "") -> Camera:
    """Build a Camera from a blender/OpenGL c2w pose the way the Blender
    loader does (reference scene/dataset_readers.py:278-284)."""
    c2w = c2w_blender.copy()
    c2w[:3, 1:3] *= -1  # blender→opencv axis flip
    w2c = np.linalg.inv(c2w)
    R = np.transpose(w2c[:3, :3])
    T = w2c[:3, 3]
    fovy = focal2fov(fov2focal(fovx, width), height)
    return Camera(uid=uid, R=R, T=T, fovx=fovx, fovy=fovy, image=image,
                  alpha_mask=alpha_mask, fid=fid, width=width, height=height,
                  image_name=image_name, orig_transform=c2w_blender.astype(np.float32))
