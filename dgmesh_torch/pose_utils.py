"""Trajectory and evaluation pose helpers.

The port's copy of dgmesh_tpu/pose_utils.py (reference utils/pose_utils.py):
spherical poses (:5-63, the D-NeRF convention), the Rodrigues pair
(:24-56), render_wander_path (:66-98, a circular wobble about a view) and
the per-method rotations that align a method's meshes for evaluation
(:102-138), which cli/mesh_evaluation.py takes from here.
"""

from __future__ import annotations

import math

import numpy as np

from .cameras import fov2focal


def _r_x(a: float) -> np.ndarray:
    return np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)],
                     [0, math.sin(a), math.cos(a)]], np.float32)


# eval-time alignment rotations (reference :102-138)
ROTATIONS = {
    "dgmesh": _r_x(math.pi / 2),
    "ours": _r_x(math.pi / 2),
    "deformable_gaussian": _r_x(math.pi / 2),
    "dnerf": _r_x(math.pi / 2),
    "hexplane": np.eye(3, dtype=np.float32),
    "tineuvox": np.eye(3, dtype=np.float32),
    "kplane": np.eye(3, dtype=np.float32),
    "none": np.eye(3, dtype=np.float32),
}


def _trans_t(t):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rot_phi(phi):
    m = np.eye(4, dtype=np.float32)
    m[1, 1] = math.cos(phi)
    m[1, 2] = -math.sin(phi)
    m[2, 1] = math.sin(phi)
    m[2, 2] = math.cos(phi)
    return m


def _rot_theta(th):
    m = np.eye(4, dtype=np.float32)
    m[0, 0] = math.cos(th)
    m[0, 2] = -math.sin(th)
    m[2, 0] = math.sin(th)
    m[2, 2] = math.cos(th)
    return m


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """D-NeRF spherical c2w pose (reference pose_spherical :58-63)."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi_deg / 180.0 * math.pi) @ c2w
    c2w = _rot_theta(theta_deg / 180.0 * math.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    np.float32)
    return flip @ c2w


def rodrigues_rot_to_mat(r: np.ndarray) -> np.ndarray:
    """Axis-angle → rotation matrix (reference :39-56)."""
    theta = float(np.linalg.norm(r))
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    wx, wy, wz = r
    a = math.cos(theta)
    b = (1 - a) / (theta * theta)
    c = math.sin(theta) / theta
    return np.array([
        [a + b * wx * wx, b * wx * wy - c * wz, b * wx * wz + c * wy],
        [b * wx * wy + c * wz, a + b * wy * wy, b * wy * wz - c * wx],
        [b * wx * wz - c * wy, b * wz * wy + c * wx, a + b * wz * wz]])


def rodrigues_mat_to_rot(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → axis-angle (reference :24-36)."""
    eps = 1e-16
    trc2 = (np.trace(R) - 1.0) / 2.0
    s = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if (1 - trc2 * trc2) >= eps:
        theta = np.arccos(trc2)
        f = theta / (2 * np.sin(theta))
    else:
        theta = np.real(np.arccos(trc2))
        f = 0.5 / (1 - theta / 6)
    return f * s


def render_wander_path(cam, num_frames: int = 60, max_disp: float = 5000.0):
    """Circular camera wobble around a reference view (reference :66-98)."""
    focal = fov2focal(cam.fovy, cam.height)
    R = cam.R.copy()
    R[:, 1] = -R[:, 1]
    R[:, 2] = -R[:, 2]
    T = -cam.T.reshape(-1, 1)
    pose = np.concatenate([R, T], -1)
    ref_pose = np.concatenate([pose, np.array([[0, 0, 0, 1.0]])], axis=0)

    max_trans = max_disp / focal
    out = []
    for i in range(num_frames):
        x = max_trans * math.sin(2 * math.pi * i / num_frames)
        y = max_trans * math.cos(2 * math.pi * i / num_frames) / 3.0
        z = max_trans * math.cos(2 * math.pi * i / num_frames) / 3.0
        i_pose = np.eye(4)
        i_pose[:3, 3] = [x, y, z]
        out.append((ref_pose @ np.linalg.inv(i_pose)).astype(np.float32))
    return out
