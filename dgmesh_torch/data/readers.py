"""Dataset readers → SceneInfo.

The port's copy of dgmesh_tpu/data/readers.py (reference
scene/dataset_readers.py): ``PointCloud``, ``SceneInfo`` and
``get_nerfpp_norm`` (:34-110) and the eight readers of
sceneLoadTypeCallbacks (:995-1004): Colmap (:113-259), Blender / D-NeRF
(:262-352), finetune-nerf (:355-453), DTU (:456-542), Nerfies (:545-677),
iPhone (:680-800), NeuralActor (:803-905) and PlenopticVideo (:908-992).
Images and masks are read as JAX reads them, through Pillow where it
imports; without Pillow a PNG goes to the port's own reader
(utils_io.decode_png), which gives Pillow's arrays (a palette mask's
indices, a SAM mask's L or 1-bit values).
The ``downsample`` of the Blender and finetune-nerf readers is Pillow's
LANCZOS resize, as data/resize.py reproduces it.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from ..cameras import Camera, camera_from_c2w_blender, focal2fov, fov2focal
from ..utils_io import read_image, read_mesh_ply
from .resize import lanczos_resize


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
    """(rgb (H,W,3), alpha (H,W,1) or None) in [0, 1]; with ``downsample``
    the file is first LANCZOS-resized to int(size / downsample)
    (dataset_readers.py:289); RGBA is composited over the background
    (:286-296)."""
    im = read_image(path)
    if downsample and downsample != 1.0:
        h, w = im.shape[:2]
        im = lanczos_resize(im, (int(w / downsample), int(h / downsample)))
    im = im.astype(np.float32) / 255.0
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


def _random_cloud_f64(half: float) -> PointCloud:
    """The 100k fallback cloud of the DTU, NeuralActor and PlenopticVideo
    readers: uniform in [-half, half]³ drawn in float64, then cast."""
    rng = np.random.default_rng(0)
    pts = (rng.random((100_000, 3)) * 2 * half - half).astype(np.float32)
    return PointCloud(points=pts, colors=rng.random((100_000, 3)).astype(np.float32))


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


def read_colmap_scene(path: str, images: str = "images",
                      white_background: bool = False, eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    """COLMAP sparse reconstruction loader (dataset_readers.py:113-259):
    sparse/0 (or sparse), R = qvec2rotmat(q)ᵀ, the SIMPLE_* models' one
    focal for both axes, every llffhold-th image held out with eval_split."""
    from . import colmap as C
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    cams_intr = C.read_cameras(sparse)
    images_meta = C.read_images(sparse)
    pts, cols = C.read_points3d(sparse)
    cam_list = []
    keys = sorted(images_meta.keys())
    n = max(len(keys) - 1, 1)
    for i, k in enumerate(keys):
        im = images_meta[k]
        intr = cams_intr[im.camera_id]
        img_path = os.path.join(path, images, im.name)
        image, alpha = _load_image(img_path, white_background)
        H, W = image.shape[:2]
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            focal_x = focal_y = intr.params[0]
        else:
            focal_x, focal_y = intr.params[0], intr.params[1]
        cam_list.append(Camera(uid=i, R=C.qvec2rotmat(im.qvec).T, T=im.tvec,
                               fovx=focal2fov(focal_x, W), fovy=focal2fov(focal_y, H),
                               image=image, alpha_mask=alpha, fid=i / n, width=W, height=H,
                               image_name=im.name))
    if eval_split:
        train = [c for i, c in enumerate(cam_list) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_list) if i % llffhold == 0]
    else:
        train, test = cam_list, []
    pc = PointCloud(points=pts.astype(np.float32), colors=cols.astype(np.float32))
    return SceneInfo(point_cloud=pc, train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train))


def _camera_nerfies_from_json(path: str, ratio: float) -> dict:
    """Nerfies per-camera json (reference utils/camera_utils.py
    camera_nerfies_from_JSON :98-118): orientation, position, focal length
    and principal point, the last two (and the image size) scaled by the
    dataset's downsample ratio."""
    with open(path) as f:
        j = json.load(f)
    return dict(
        orientation=np.asarray(j["orientation"], np.float64),
        position=np.asarray(j["position"], np.float64),
        focal_length=float(j["focal_length"]) * ratio,
        principal_point=np.asarray(j["principal_point"], np.float64) * ratio,
        image_size=np.asarray(j["image_size"], np.int32) * ratio
        if "image_size" in j else None,
    )


def _masked_image(img_path: str, mask_path: str, white_background: bool):
    """The frame with the background outside its mask (image (H,W,3), mask
    (H,W,1)): a 3-channel mask (DEVA's label images) by its first channel
    > 0, a one-channel one (SAM's L or 1-bit masks, DEVA's palette
    indices) by > 0."""
    image = read_image(img_path).astype(np.float32)[..., :3] / 255.0
    mask = read_image(mask_path)
    mask = mask[..., 0] > 0 if mask.ndim == 3 else mask > 0
    bg = 1.0 if white_background else 0.0
    image = np.where(mask[..., None], image, bg).astype(np.float32)
    return image, mask[..., None].astype(np.float32)


def _nerfies_style_cameras(path: str, white_background: bool, ratio: float,
                           scene_center, coord_scale):
    """The camera loop of Nerfies and iPhone (dataset_readers.py:545-800):
    train_ids then val_ids; time from time_id (else warp_id) over its
    largest value; the position recentred and scaled by scene.json where
    given; R = orientationᵀ and T = -position·orientationᵀ; K from the
    (ratio-scaled) focal length and principal point; the OpenCV c2w flipped
    to Blender's axes as ``orig_transform``; frames under rgb/<1/ratio>x and
    masks under mask-tracking/<1/ratio>x/Annotations."""
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "dataset.json")) as f:
        ds = json.load(f)
    train_ids = ds["train_ids"]
    all_ids = train_ids + ds["val_ids"]
    key = "time_id" if "time_id" in meta[all_ids[0]] else "warp_id"
    times = [meta[i][key] for i in all_ids]
    max_t = max(max(times), 1)
    times = [t / max_t for t in times]
    cams = []
    sub = f"{int(1 / ratio)}x"
    for idx, im in enumerate(all_ids):
        cp = _camera_nerfies_from_json(os.path.join(path, "camera", im + ".json"), ratio)
        pos = cp["position"]
        if scene_center is not None:
            pos = (pos - np.asarray(scene_center)) * coord_scale
        orientation = cp["orientation"].T
        position = -pos @ orientation
        image, alpha = _masked_image(
            os.path.join(path, "rgb", sub, im + ".png"),
            os.path.join(path, "mask-tracking", sub, "Annotations", im + ".png"),
            white_background)
        H, W = image.shape[:2]
        focal = cp["focal_length"]
        pp = cp["principal_point"]
        K = np.array([[focal, 0, pp[0]], [0, focal, pp[1]], [0, 0, 1]], np.float32)
        w2c = np.eye(4)
        w2c[:3, :3] = orientation.T
        w2c[:3, 3] = position
        c2w = np.linalg.inv(w2c)      # OpenCV
        c2w[:3, 1:3] *= -1            # → Blender / OpenGL
        cams.append(Camera(uid=idx, R=orientation, T=position,
                           fovx=focal2fov(focal, W), fovy=focal2fov(focal, H),
                           image=image, alpha_mask=alpha, fid=times[idx],
                           width=W, height=H, image_name=im, K=K,
                           orig_transform=c2w.astype(np.float32)))
    return cams, len(train_ids)


def _pcd_from_points_npy(path: str, scene_center=None, coord_scale=None) -> PointCloud:
    """points3d.ply where present, else points.npy (recentred and scaled
    like the cameras) with colours from numpy's global generator, as the
    reference draws them (dataset_readers.py:640-650)."""
    ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        return load_points_ply(ply_path)
    xyz = np.load(os.path.join(path, "points.npy"))
    if scene_center is not None:
        xyz = (xyz - np.asarray(scene_center)) * coord_scale
    colors = np.random.random((xyz.shape[0], 3)).astype(np.float32) * (0.5 / 255) + 0.5
    return PointCloud(points=xyz.astype(np.float32), colors=colors)


def _split(cams, train_num: int, eval_split: bool):
    return (cams[:train_num], cams[train_num:]) if eval_split else (cams, [])


def read_nerfies_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, nerfies_ratio: float = 0.5,
                       **_) -> SceneInfo:
    """Nerfies loader (dataset_readers.py:545-677): scene.json's centre and
    scale recentre the cameras and the points."""
    with open(os.path.join(path, "scene.json")) as f:
        scene_json = json.load(f)
    cams, train_num = _nerfies_style_cameras(path, white_background, nerfies_ratio,
                                             scene_json["center"], scene_json["scale"])
    train, test = _split(cams, train_num, eval_split)
    pc = _pcd_from_points_npy(path, scene_json["center"], scene_json["scale"])
    return SceneInfo(point_cloud=pc, train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train))


def read_iphone_scene(path: str, white_background: bool = False,
                      eval_split: bool = True, **_) -> SceneInfo:
    """iPhone (DyCheck-style) loader (dataset_readers.py:680-800): Nerfies'
    layout at ratio 1, no recentring."""
    cams, train_num = _nerfies_style_cameras(path, white_background, 1.0, None, None)
    train, test = _split(cams, train_num, eval_split)
    return SceneInfo(point_cloud=_pcd_from_points_npy(path), train_cameras=train,
                     test_cameras=test, nerf_normalization=get_nerfpp_norm(train))


_B2CV = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)


def _read_neural_actor_split(path: str, transformsfile: str, white_background: bool,
                             load_num: int = 1500):
    """NeuralActor split (dataset_readers.py:803-905): OpenCV c2w poses, a
    per-frame ``intrinsic`` K, masks under <split>_mask/Annotations."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    sub = "training" if "train" in transformsfile else "testing"
    cams = []
    for idx, frame in enumerate(contents["frames"][:load_num]):
        c2w = np.asarray(frame["transform_matrix"], np.float64)
        orig_cam = c2w @ np.linalg.inv(_B2CV)   # the Blender-convention c2w
        w2c = np.linalg.inv(c2w)
        img_path = os.path.join(path, frame["file_path"])
        mask_path = img_path.replace(f"/{sub}/", f"/{sub}_mask/Annotations/")
        image, alpha = _masked_image(img_path, mask_path, white_background)
        H, W = image.shape[:2]
        K = np.asarray(frame["intrinsic"], np.float32)
        cams.append(Camera(
            uid=idx, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
            fovx=focal2fov(K[0, 0], W), fovy=focal2fov(K[1, 1], H), image=image,
            alpha_mask=alpha, fid=float(frame["time"]), width=W, height=H,
            image_name=os.path.basename(img_path), K=K,
            orig_transform=orig_cam.astype(np.float32)))
    return cams


def read_neural_actor_scene(path: str, white_background: bool = False,
                            eval_split: bool = True, **_) -> SceneInfo:
    train = _read_neural_actor_split(path, "transforms_train.json", white_background)
    test = _read_neural_actor_split(path, "transforms_test.json", white_background)
    if not eval_split:
        train, test = train + test, []
    ply_path = os.path.join(path, "points3d.ply")
    pc = load_points_ply(ply_path) if os.path.exists(ply_path) else _random_cloud_f64(1.0)
    return SceneInfo(point_cloud=pc, train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train))


def _load_K_Rt_from_P(P: np.ndarray):
    """A 3x4 projection → K (3,3) and the c2w pose (4,4) by RQ (the
    reference's cv2.decomposeProjectionMatrix; scipy's rq, K's diagonal made
    positive)."""
    from scipy.linalg import rq
    K, R = rq(P[:3, :3])
    S = np.diag(np.sign(np.diag(K)))
    K = K @ S
    R = S @ R
    t = np.linalg.inv(K) @ P[:3, 3]
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T
    pose[:3, 3] = -R.T @ t
    return K.astype(np.float32), pose


def read_dtu_scene(path: str, render_camera: str = "cameras_sphere.npz",
                   white_background: bool = False, **_) -> SceneInfo:
    """NeuS-style DTU loader (dataset_readers.py:456-542): P = world_mat @
    scale_mat decomposed into K and a pose, then the reference's axis
    shuffle; image/*.png times mask/*.png."""
    import glob
    camera_dict = np.load(os.path.join(path, render_camera))
    images_lis = sorted(glob.glob(os.path.join(path, "image/*.png")))
    masks_lis = sorted(glob.glob(os.path.join(path, "mask/*.png")))
    n = len(images_lis)
    cams = []
    for idx in range(n):
        image = read_image(images_lis[idx]).astype(np.float32) / 255.0
        mask = read_image(masks_lis[idx]).astype(np.float32) / 255.0
        if mask.ndim == 3:
            mask = mask[..., 0]
        img = image[..., :3] * mask[..., None]
        world_mat = camera_dict[f"world_mat_{idx}"].astype(np.float32)
        scale_mat = camera_dict[f"scale_mat_{idx}"].astype(np.float32)
        fid = float(camera_dict[f"fid_{idx}"]) / max(n / 12 - 1, 1)
        K, pose = _load_K_Rt_from_P((world_mat @ scale_mat)[:3, :4])
        # the reference's axis shuffle (dataset_readers.py:478-497)
        a, b, c = pose[0:1], pose[1:2], pose[2:3]
        pose = np.concatenate([a, -c, -b, pose[3:]], 0)
        S = np.diag([1.0, -1.0, -1.0])
        pose[1, 3] = -pose[1, 3]
        pose[2, 3] = -pose[2, 3]
        pose[:3, :3] = S @ pose[:3, :3] @ S
        a, b, c = pose[0:1], pose[1:2], pose[2:3]
        pose = np.concatenate([a, c, b, pose[3:]], 0)
        pose[:, 3] *= 0.5
        matrix = np.linalg.inv(pose)
        R = -np.transpose(matrix[:3, :3])
        R[:, 0] = -R[:, 0]
        H, W = img.shape[:2]
        cams.append(Camera(uid=idx, R=R, T=-matrix[:3, 3],
                           fovx=focal2fov(K[0, 0], W), fovy=focal2fov(K[0, 0], H),
                           image=img.astype(np.float32),
                           alpha_mask=mask[..., None].astype(np.float32),
                           fid=fid, width=W, height=H,
                           image_name=os.path.basename(images_lis[idx])))
    return SceneInfo(point_cloud=_random_cloud_f64(1.3), train_cameras=cams, test_cameras=[],
                     nerf_normalization=get_nerfpp_norm(cams))


def read_plenoptic_scene(path: str, eval_split: bool = True, num_images: int = 300,
                         hold_id=(0,), **_) -> SceneInfo:
    """Neural 3D Video loader (dataset_readers.py:908-992): LLFF's
    poses_bounds.npy (its columns swapped to (y, -x, z), then flipped to
    OpenCV) and frames/<camera>/*; the cameras of ``hold_id`` are the test
    set."""
    import glob
    video_paths = sorted(glob.glob(os.path.join(path, "frames/*")))
    poses_bounds = np.load(os.path.join(path, "poses_bounds.npy"))
    poses = poses_bounds[:, :15].reshape(-1, 3, 5)
    focal = poses[0, 2, -1]
    n_cameras = poses.shape[0]
    poses = np.concatenate([poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
    bottoms = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4), (n_cameras, 1, 1))
    poses = np.concatenate([poses, bottoms], axis=1) @ np.diag([1.0, -1, -1, 1])

    def split_cams(split):
        held = set(hold_id)
        sel = sorted(held) if split != "train" else sorted(set(range(n_cameras)) - held)
        out = []
        for i in sel:
            matrix = np.linalg.inv(poses[i])
            names = sorted(os.listdir(video_paths[i]))[:num_images]
            for idx, name in enumerate(names):
                img = read_image(os.path.join(video_paths[i], name)).astype(np.float32) / 255.0
                h, w = img.shape[:2]
                out.append(Camera(
                    uid=idx, R=np.transpose(matrix[:3, :3]), T=matrix[:3, 3],
                    fovx=focal2fov(focal, w), fovy=focal2fov(focal, h), image=img[..., :3],
                    alpha_mask=None, fid=idx / max(len(names) - 1, 1), width=w, height=h,
                    image_name=name))
        return out

    train = split_cams("train")
    test = split_cams("test") if eval_split else []
    ply_path = os.path.join(path, "points3D_downsample.ply")
    pc = load_points_ply(ply_path) if os.path.exists(ply_path) else _random_cloud_f64(1.3)
    return SceneInfo(point_cloud=pc, train_cameras=train, test_cameras=test,
                     nerf_normalization=get_nerfpp_norm(train))


# sceneLoadTypeCallbacks (dataset_readers.py:995-1004)
SCENE_READERS: Dict[str, Callable] = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
    "DTU": read_dtu_scene,
    "nerfies": read_nerfies_scene,
    "iPhone": read_iphone_scene,
    "NeuralActor": read_neural_actor_scene,
    "PlenopticVideo": read_plenoptic_scene,
    "finetune-nerf": read_finetune_nerf_scene,
}
