"""COLMAP binary/text model parsing.

The port's copy of dgmesh_tpu/data/colmap.py (reference
scene/colmap_loader.py): cameras, images and points3D in their .bin and
.txt forms, and ``qvec2rotmat``.  points3D.bin is walked record by record
over the file's bytes (JAX's native C++ parse, dgmesh_tpu/native.py, only
speeds up the same walk).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODELS.items()}


class CameraIntr(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ImageMeta(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras(sparse_dir: str) -> Dict[int, CameraIntr]:
    binp = os.path.join(sparse_dir, "cameras.bin")
    txtp = os.path.join(sparse_dir, "cameras.txt")
    out = {}
    if os.path.exists(binp):
        with open(binp, "rb") as f:
            (n,) = _read(f, "<Q")
            for _ in range(n):
                cid, model_id, w, h = _read(f, "<iiQQ")
                name, nparams = CAMERA_MODELS[model_id]
                params = np.array(_read(f, "<" + "d" * nparams))
                out[cid] = CameraIntr(cid, name, int(w), int(h), params)
    else:
        with open(txtp) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                cid = int(parts[0])
                out[cid] = CameraIntr(cid, parts[1], int(parts[2]), int(parts[3]),
                                      np.array([float(p) for p in parts[4:]]))
    return out


def read_images(sparse_dir: str) -> Dict[int, ImageMeta]:
    binp = os.path.join(sparse_dir, "images.bin")
    txtp = os.path.join(sparse_dir, "images.txt")
    out = {}
    if os.path.exists(binp):
        with open(binp, "rb") as f:
            (n,) = _read(f, "<Q")
            for _ in range(n):
                iid = _read(f, "<i")[0]
                qvec = np.array(_read(f, "<dddd"))
                tvec = np.array(_read(f, "<ddd"))
                (cam_id,) = _read(f, "<i")
                name = b""
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    name += c
                (npts,) = _read(f, "<Q")
                f.read(24 * npts)  # skip 2D points (x, y, point3D_id)
                out[iid] = ImageMeta(iid, qvec, tvec, cam_id, name.decode())
    else:
        with open(txtp) as f:
            lines = [l.strip() for l in f
                     if l.strip() and not l.startswith("#")]
        for meta_line in lines[0::2]:
            parts = meta_line.split()
            iid = int(parts[0])
            qvec = np.array([float(p) for p in parts[1:5]])
            tvec = np.array([float(p) for p in parts[5:8]])
            out[iid] = ImageMeta(iid, qvec, tvec, int(parts[8]), parts[9])
    return out


def _points3d_bin(path: str):
    """xyz (N,3) float64 and rgb (N,3) uint8 of a points3D.bin: per point an
    id (u64), xyz (3 f64), rgb (3 u8), the error (f64) and a track of
    (image id, point2D index) pairs (u64 length, 8 bytes a pair)."""
    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack_from("<Q", blob, 0)
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    pos = 8
    for i in range(n):
        xyz[i] = struct.unpack_from("<ddd", blob, pos + 8)
        rgb[i] = struct.unpack_from("<BBB", blob, pos + 32)
        (track_len,) = struct.unpack_from("<Q", blob, pos + 43)
        pos += 51 + 8 * track_len
    return xyz, rgb


def read_points3d(sparse_dir: str):
    """(xyz (N,3), rgb (N,3) in [0, 1]), both float64."""
    binp = os.path.join(sparse_dir, "points3D.bin")
    txtp = os.path.join(sparse_dir, "points3D.txt")
    if os.path.exists(binp):
        xyz, rgb = _points3d_bin(binp)
        return xyz, rgb.astype(np.float64) / 255.0
    pts, cols = [], []
    with open(txtp) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pts.append([float(p) for p in parts[1:4]])
            cols.append([float(p) for p in parts[4:7]])
    pts = np.asarray(pts, np.float64)
    cols = np.asarray(cols, np.float64) / 255.0
    return pts, cols
