"""Dataset readers → SceneInfo.

The port's copy of the two readers of dgmesh_tpu/data/readers.py that the
shipped synthetic configs use (reference scene/dataset_readers.py): Blender
/ D-NeRF (:262-352) and finetune-nerf (:355-453), with ``PointCloud``,
``SceneInfo`` and ``get_nerfpp_norm`` (:34-110).  Images are read by the
port's own PNG reader (utils_io.py).  The other formats (Colmap, DTU,
nerfies, iPhone, NeuralActor, PlenopticVideo) and the LANCZOS downsample
are not ported yet: asking for either raises.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..cameras import Camera, camera_from_c2w_blender, focal2fov, fov2focal
from ..utils_io import read_mesh_ply, read_png


@dataclass
class PointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: Optional[np.ndarray] = None


@dataclass
class SceneInfo:
    point_cloud: PointCloud
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    nerf_normalization: dict
    ply_path: Optional[str] = None


def get_nerfpp_norm(cameras: List[Camera]) -> dict:
    """Scene radius/translate from camera centers (dataset_readers.py:89-110)."""
    centers = np.stack([c.camera_center for c in cameras])
    avg = centers.mean(axis=0)
    dists = np.linalg.norm(centers - avg, axis=1)
    radius = dists.max() * 1.1
    return dict(translate=-avg, radius=float(radius if radius > 0 else 1.0))


def _load_image(path: str, white_background: bool, downsample: float = 1.0):
    """(rgb (H,W,3), alpha (H,W,1) or None) in [0, 1]; RGBA is composited
    over the background (dataset_readers.py:286-296)."""
    if downsample and downsample != 1.0:
        raise NotImplementedError(
            "downsample != 1 needs the reference's LANCZOS resize, which the port "
            "has not ported yet")
    im = read_png(path).astype(np.float32) / 255.0
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, -1)
    if im.shape[-1] == 4:
        alpha = im[..., 3:4]
        bg = 1.0 if white_background else 0.0
        rgb = im[..., :3] * alpha + bg * (1 - alpha)
        return rgb.astype(np.float32), alpha.astype(np.float32)
    return im[..., :3], None


def _random_cloud() -> PointCloud:
    """The random 100k init cloud (dataset_readers.py:330-341, 432-441)."""
    rng = np.random.default_rng(0)
    n = 100_000
    return PointCloud(points=(rng.random((n, 3)).astype(np.float32) * 2.6 - 1.3),
                      colors=rng.random((n, 3)).astype(np.float32))


def _frames(path: str, transforms: str, max_frames: Optional[int]):
    fname = os.path.join(path, transforms)
    if not os.path.exists(fname):
        return None, []
    with open(fname) as f:
        meta = json.load(f)
    frames = meta["frames"]
    return meta["camera_angle_x"], frames[:max_frames] if max_frames else frames


def _image_path(path: str, fr: dict, extension: str) -> str:
    p = os.path.join(path, fr["file_path"] + extension)
    return p if os.path.exists(p) else os.path.join(path, fr["file_path"])


def _cloud(path: str):
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        return load_points_ply(ply_path), ply_path
    return _random_cloud(), None


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, extension: str = ".png",
                       max_frames: Optional[int] = None,
                       downsample: float = 1.0) -> SceneInfo:
    """Blender / D-NeRF transforms_{train,test}.json loader
    (dataset_readers.py:262-352).  fid = frame `time` field when present,
    else linear in frame index."""

    def read_split(split):
        fovx, frames = _frames(path, f"transforms_{split}.json", max_frames)
        cams = []
        n = max(len(frames) - 1, 1)
        for i, fr in enumerate(frames):
            img_path = _image_path(path, fr, extension)
            image, alpha = _load_image(img_path, white_background, downsample)
            H, W = image.shape[:2]
            cams.append(camera_from_c2w_blender(
                uid=i, c2w_blender=np.asarray(fr["transform_matrix"], np.float32), fovx=fovx,
                width=W, height=H, fid=float(fr.get("time", i / n)), image=image,
                alpha_mask=alpha, image_name=os.path.basename(img_path)))
        return cams

    train_cams = read_split("train")
    test_cams = read_split("test") if eval_split else []
    pc, ply_path = _cloud(path)
    return SceneInfo(point_cloud=pc, train_cameras=train_cams, test_cameras=test_cams,
                     nerf_normalization=get_nerfpp_norm(train_cams or test_cams),
                     ply_path=ply_path)


def load_points_ply(path: str) -> PointCloud:
    """Minimal PLY point loader (xyz + rgb), binary or ascii."""
    with open(path, "rb") as f:
        props = []
        n = 0
        fmt = "binary_little_endian"
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                props.append((line.split()[1], line.split()[-1]))
            elif line == "end_header":
                break
        names = [p[1] for p in props]
        if fmt.startswith("ascii"):
            data = np.loadtxt(f, max_rows=n).reshape(n, len(names))
        else:
            dt = np.dtype([(nm, {"float": "<f4", "float32": "<f4", "double": "<f8",
                                 "uchar": "u1", "uint8": "u1", "int": "<i4"}[t])
                           for t, nm in props])
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt)
            data = np.stack([raw[nm].astype(np.float64) for nm in names], axis=1)
    col = {nm: i for i, nm in enumerate(names)}
    pts = data[:, [col["x"], col["y"], col["z"]]].astype(np.float32)
    if "red" in col:
        colors = data[:, [col["red"], col["green"], col["blue"]]].astype(np.float32)
        if colors.max() > 1.5:
            colors = colors / 255.0
    else:
        colors = np.full_like(pts, 0.5)
    normals = None
    if "nx" in col:
        normals = data[:, [col["nx"], col["ny"], col["nz"]]].astype(np.float32)
    return PointCloud(points=pts, colors=colors, normals=normals)


def read_finetune_nerf_scene(path: str, white_background: bool = False,
                             eval_split: bool = True, mesh_path: str = None,
                             mesh_path_test: str = None, cam_scale: float = 1.0,
                             extension: str = ".png",
                             max_frames: Optional[int] = None,
                             downsample: float = 1.0, **kw) -> SceneInfo:
    """The finetune-nerf loader (dataset_readers.py:355-453): `time` is
    required per frame; the camera translation is scaled by ``cam_scale``;
    FovY gets camera_angle_x and FovX the derived value (the reference's
    swap, :399-401); with ``mesh_path`` every frame loads its GT mesh
    ``frame_<N>.ply``, N from the image name's ``_``-split (:403-407);
    without eval_split the test frames join the training set (:421-423)."""

    def read_split(transformsfile, mdir):
        fovx, frames = _frames(path, transformsfile, max_frames)
        cams = []
        for i, fr in enumerate(frames):
            img_path = _image_path(path, fr, extension)
            image, alpha = _load_image(img_path, white_background, downsample)
            H, W = image.shape[:2]
            c2w = np.asarray(fr["transform_matrix"], np.float64)
            flip = c2w.copy()
            flip[:3, 1:3] *= -1                  # blender→opencv (:374)
            w2c = np.linalg.inv(flip)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3] * cam_scale           # (:380)
            fovy_derived = focal2fov(fov2focal(fovx, W), H)
            image_name = os.path.splitext(os.path.basename(img_path))[0]
            mv = mf = None
            if mdir:
                frame_num = int(image_name.split("_")[1])   # (:404)
                mv, mf = read_mesh_ply(os.path.join(mdir, f"frame_{frame_num}.ply"))
            cams.append(Camera(
                uid=i, R=R.astype(np.float32), T=T.astype(np.float32),
                fovx=fovy_derived, fovy=fovx, image=image, alpha_mask=alpha,
                fid=float(fr["time"]), width=W, height=H, image_name=image_name,
                orig_transform=c2w.astype(np.float32), mesh_verts=mv, mesh_faces=mf))
        return cams

    train_cams = read_split("transforms_train.json", mesh_path)
    test_cams = read_split("transforms_test.json", mesh_path_test)
    if not eval_split:
        train_cams, test_cams = train_cams + test_cams, []
    pc, ply_path = _cloud(path)
    return SceneInfo(point_cloud=pc, train_cameras=train_cams, test_cameras=test_cams,
                     nerf_normalization=get_nerfpp_norm(train_cams or test_cams),
                     ply_path=ply_path)


# the readers of sceneLoadTypeCallbacks (dataset_readers.py:995-1004) that
# the port has
SCENE_READERS: Dict[str, Callable] = {
    "Blender": read_blender_scene,
    "finetune-nerf": read_finetune_nerf_scene,
}
