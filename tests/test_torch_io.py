"""The port's files and data against the JAX package's: the PNG codec
against Pillow, the Gaussian and mesh PLY files both ways, the scene
readers and ``Scene`` on a dataset written by JAX's generator, and the
port's generator against JAX's.

The JAX dataset (``dgmesh_tpu.data.synthetic_mesh.generate_mesh_dataset``
at 64², icosphere subdiv 3, 4 training frames and 1 test frame, rendered by
JAX's XLA raster and written by Pillow) is made once for the module; the
port's (its own raster's twin on the CPU, its own PNG writer) beside it.
"""

import json
import os
import struct
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch import utils_io as TIO  # noqa: E402
from dgmesh_torch.config import Config as TConfig  # noqa: E402
from dgmesh_torch.data import scene as TScene  # noqa: E402
from dgmesh_torch.data import synthetic_mesh as TSM  # noqa: E402
from dgmesh_torch.models import gaussians as TG  # noqa: E402
from dgmesh_tpu import utils_io as JIO  # noqa: E402
from dgmesh_tpu.config import Config as JConfig  # noqa: E402
from dgmesh_tpu.data import scene as JScene  # noqa: E402
from dgmesh_tpu.data import synthetic_mesh as JSM  # noqa: E402
from dgmesh_tpu.models import gaussians as JG  # noqa: E402

torch.set_num_threads(1)

FRAMES, TEST, SIZE, SUBDIV = 4, 1, 64, 3


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("io")
    jdir, tdir = str(root / "jax"), str(root / "port")
    JSM.generate_mesh_dataset(jdir, n_frames=FRAMES, width=SIZE, height=SIZE, n_test=TEST,
                              subdiv=SUBDIV)
    TSM.generate_mesh_dataset(tdir, n_frames=FRAMES, width=SIZE, height=SIZE, n_test=TEST,
                              subdiv=SUBDIV, device="cpu")
    return jdir, tdir


# --- PNG ------------------------------------------------------------------------

def _image(shape, seed):
    """A smooth image with noise: Pillow's adaptive filtering picks several
    filter types on it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    base = np.sin(xx / 7.0) * 80 + np.cos(yy / 5.0) * 60 + 120
    ch = shape[2] if len(shape) == 3 else 1
    img = base[..., None] + rng.integers(0, 20, shape[:2] + (ch,))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if len(shape) == 2 else img


def _png_with_filters(img, filters):
    """A PNG whose row y is filtered with filters[y % len(filters)] (PNG spec
    §9), written here, independently of the port's writer."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        ft = filters[y % len(filters)]
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = {1: 0, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (40, 29, 4)])
def test_png_reader_undoes_every_filter_type_as_pillow(shape, tmp_path):
    """Rows filtered None, Sub, Up, Average and Paeth in turn: the port's
    reader without Pillow (decode_png), read_png and Pillow all give the
    image back exactly."""
    img = _image(shape, len(shape))
    p = tmp_path / "f.png"
    p.write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4, 4, 3, 1]))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    np.testing.assert_array_equal(TIO.read_png(str(p)), img)
    np.testing.assert_array_equal(TIO.decode_png(p.read_bytes()), img)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (40, 29, 4)])
def test_png_codec_against_pillow_both_ways(shape, tmp_path):
    """Pillow's file (its own filter choice) read by the port, with Pillow
    and without it (decode_png), and the port's file read by Pillow: the
    same pixels."""
    img = _image(shape, 7)
    a, b = tmp_path / "pil.png", tmp_path / "port.png"
    Image.fromarray(img).save(a)
    TIO.write_png(str(b), img)
    np.testing.assert_array_equal(TIO.read_png(str(a)), img)
    np.testing.assert_array_equal(TIO.decode_png(a.read_bytes()), img)
    np.testing.assert_array_equal(np.asarray(Image.open(b)), img)


def test_save_image_matches_jax_save_image(tmp_path):
    """A float image in [0, 1] (values outside clipped) saved by the port and
    by JAX's save_image (Pillow): the same pixels."""
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.2, (21, 17, 3)).astype(np.float32)
    TIO.save_image(str(tmp_path / "t.png"), img)
    JIO.save_image(str(tmp_path / "j.png"), img)
    np.testing.assert_array_equal(TIO.read_png(str(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    """A file that is no PNG raises, naming the file, with Pillow and
    without it; an interlaced (Adam7) PNG is read, as Pillow reads it
    (every colour type and depth, interlaced or not:
    test_torch_readers.py)."""
    from torch_capture_fixtures import build_png
    p = tmp_path / "i.png"
    img = _image((4, 4, 3), 2)
    p.write_bytes(build_png(img, 8, 2, interlace=1))
    np.testing.assert_array_equal(TIO.read_png(str(p)), np.asarray(Image.open(p)))
    np.testing.assert_array_equal(TIO.decode_png(p.read_bytes(), str(p)), img)
    q = tmp_path / "j.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(q, format="JPEG")
    with pytest.raises(ValueError, match="j.png: not a PNG"):
        TIO.read_png(str(q))
    with pytest.raises(ValueError, match="j.png: not a PNG"):
        TIO.decode_png(q.read_bytes(), str(q))


# --- PLY ------------------------------------------------------------------------

def _gaussians(n, M, seed):
    """The same live Gaussians as JAX and port tuples (sh degree 3)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    leaves = dict(xyz=f(M, 3), f_dc=f(M, 1, 3), f_rest=f(M, 15, 3), scaling=f(M, 3),
                  rotation=f(M, 4), opacity=f(M, 1), normal=f(M, 3))
    alive = np.zeros(M, bool)
    alive[rng.choice(M, n, replace=False)] = True
    jgp = JG.GaussianParams(**{k: jnp.asarray(v) for k, v in leaves.items()},
                            density_thres=jnp.asarray(0.0625, jnp.float32))
    jgs = JG.GaussianStats(alive=jnp.asarray(alive), max_radii2d=jnp.zeros(M),
                           xyz_grad_accum=jnp.zeros(M), denom=jnp.zeros(M),
                           gaussian_center=jnp.asarray([0.1, -0.2, 0.3], jnp.float32),
                           gaussian_scale=jnp.asarray(0.75, jnp.float32))
    tgp = TG.GaussianParams(**{k: torch.tensor(v) for k, v in leaves.items()},
                            density_thres=torch.tensor(0.0625))
    tgs = TG.GaussianStats(alive=torch.tensor(alive), max_radii2d=torch.zeros(M),
                           xyz_grad_accum=torch.zeros(M), denom=torch.zeros(M),
                           gaussian_center=torch.tensor([0.1, -0.2, 0.3]),
                           gaussian_scale=torch.tensor(0.75))
    return (jgp, jgs), (tgp, tgs)


def test_gaussian_ply_is_jax_layout_byte_for_byte(tmp_path):
    (jgp, jgs), (tgp, tgs) = _gaussians(150, 256, 0)
    JG.save_ply(str(tmp_path / "j.ply"), jgp, jgs)
    TG.save_ply(str(tmp_path / "t.ply"), tgp, tgs)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("direction", ["port to jax", "jax to port"])
def test_gaussian_ply_round_trip_between_packages(direction, tmp_path):
    """One package writes, the other reads into 300 slots: every leaf
    exactly, the live Gaussians first, in slot order."""
    (jgp, jgs), (tgp, tgs) = _gaussians(150, 256, 1)
    p = str(tmp_path / "g.ply")
    if direction == "port to jax":
        TG.save_ply(p, tgp, tgs)
        gp, gs = JG.load_ply(p, 300)
        to_np = np.asarray
    else:
        JG.save_ply(p, jgp, jgs)
        gp, gs = TG.load_ply(p, 300, device="cpu")
        to_np = lambda x: x.numpy()  # noqa: E731
    alive = np.asarray(jgs.alive)
    for f in TG.GaussianParams._fields:
        want = np.asarray(getattr(jgp, f))
        got = to_np(getattr(gp, f))
        if f == "density_thres":
            assert got == want
            continue
        np.testing.assert_array_equal(got[:150], want[alive], err_msg=f)
        assert not got[150:].any()
    assert to_np(gs.alive).sum() == 150 and to_np(gs.alive)[:150].all()
    np.testing.assert_array_equal(to_np(gs.gaussian_center), np.asarray(jgs.gaussian_center))
    assert float(gs.gaussian_scale) == 0.75


def test_mesh_files_match_jax(tmp_path):
    """Mesh PLY (with and without colours) and OBJ: the port's bytes are
    JAX's, and each package reads the other's."""
    rng = np.random.default_rng(2)
    v = rng.normal(size=(40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (70, 3)).astype(np.int32)
    c = rng.random((40, 3)).astype(np.float32)
    for cols in (None, c):
        TIO.write_mesh_ply(str(tmp_path / "t.ply"), v, f, cols)
        JIO.write_mesh_ply(str(tmp_path / "j.ply"), v, f, cols)
        assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
        for verts, faces in (TIO.read_mesh_ply(str(tmp_path / "j.ply")),
                             JIO.read_mesh_ply(str(tmp_path / "t.ply"))):
            np.testing.assert_array_equal(verts, v)
            np.testing.assert_array_equal(faces, f)
    TIO.write_obj(str(tmp_path / "t.obj"), v, f)
    JIO.write_obj(str(tmp_path / "j.obj"), v, f)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    for a, b in zip(TIO.read_obj(str(tmp_path / "j.obj")), JIO.read_obj(str(tmp_path / "j.obj"))):
        np.testing.assert_array_equal(a, b)


# --- the generator ----------------------------------------------------------------

def test_generator_matches_jax(datasets):
    """The port's generate_mesh_dataset against JAX's at the same size: the
    transforms, the GT meshes and the init points byte for byte; each image
    within one 8-bit step (the two rasters' float32 colours round across a
    quantisation boundary at a few pixels), the coverage (alpha) exactly."""
    jdir, tdir = datasets
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        assert json.loads(Path(tdir, name).read_text()) == json.loads(Path(jdir, name).read_text())
    for rel in ["points3d.ply"] + [f"mesh/frame_{i}.ply" for i in range(FRAMES)] + \
            [f"mesh_test/frame_{i}.ply" for i in range(TEST)]:
        assert Path(tdir, rel).read_bytes() == Path(jdir, rel).read_bytes(), rel
    worst, moved = 0, 0
    for split, n in (("train", FRAMES), ("test", TEST)):
        for i in range(n):
            want = np.asarray(Image.open(Path(jdir, split, f"r_{i:03d}.png"))).astype(int)
            got = TIO.read_png(str(Path(tdir, split, f"r_{i:03d}.png"))).astype(int)
            assert got.shape == want.shape == (SIZE, SIZE, 4)
            np.testing.assert_array_equal(got[..., 3], want[..., 3])
            worst = max(worst, int(np.abs(got - want).max()))
            moved += int((got != want).any(-1).sum())
            assert (want[..., 3] > 0).mean() > 0.1          # the object covers the view
    assert worst <= 1 and moved <= 0.01 * SIZE * SIZE * (FRAMES + TEST)


# --- the readers and Scene --------------------------------------------------------

def _configs(path, data_type, mesh_dir=""):
    j, t = JConfig(), TConfig()
    for c in (j, t):
        c.model.source_path = path
        c.model.data_type = data_type
        c.model.eval = True
        c.model.pretrain_mesh_path = mesh_dir
    return j, t


@pytest.mark.parametrize("data_type", ["finetune-nerf", ""])
def test_scene_matches_jax(datasets, data_type):
    """Scene on JAX's dataset, as finetune-nerf (with its GT meshes) and as
    Blender (sniffed from transforms_train.json): the shuffled camera order,
    every camera's pose, fields of view, time, size, name, image and mask,
    the GT meshes, the extent and the point cloud, all exactly JAX's."""
    jdir, _ = datasets
    mesh_dir = os.path.join(jdir, "mesh") if data_type else ""
    jc, tc = _configs(jdir, data_type, mesh_dir)
    js, ts = JScene.Scene(jc, shuffle=True, seed=6666), TScene.Scene(tc, shuffle=True, seed=6666)
    assert ts.cameras_extent == js.cameras_extent and ts.time_interval == js.time_interval
    for jl, tl in ((js.train_cameras, ts.train_cameras), (js.test_cameras, ts.test_cameras)):
        assert [c.image_name for c in tl] == [c.image_name for c in jl] and len(tl) > 0
        for a, b in zip(tl, jl):
            for f in ("uid", "fovx", "fovy", "fid", "width", "height"):
                assert getattr(a, f) == getattr(b, f), f
            for f in ("R", "T", "image", "alpha_mask", "orig_transform", "mesh_verts",
                      "mesh_faces"):
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), f
                if y is not None:
                    np.testing.assert_array_equal(x, y, err_msg=f)
                    assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(a.mesh_pose(), b.mesh_pose())
    assert [c.image_name for c in ts.train_cameras] != sorted(c.image_name
                                                               for c in ts.train_cameras)
    if data_type:
        assert ts.train_cameras[0].mesh_verts is not None
    for f in ("points", "colors", "normals"):
        x, y = getattr(ts.point_cloud, f), getattr(js.point_cloud, f)
        assert (x is None) == (y is None)
        if y is not None:
            np.testing.assert_array_equal(x, y)


def test_scene_refuses_what_is_not_ported(datasets, tmp_path, monkeypatch):
    """The port has no JPEG decoder of its own: a dataset with a JPEG frame
    reads through Pillow where it imports (JAX's Scene exactly), and raises
    naming the file where it does not."""
    import shutil
    _, tdir = datasets
    d = str(tmp_path / "jpeg")
    shutil.copytree(tdir, d)
    Image.open(os.path.join(d, "train", "r_000.png")).convert("RGB").save(
        os.path.join(d, "train", "r_000.jpg"), quality=95)
    os.remove(os.path.join(d, "train", "r_000.png"))
    meta = json.loads(Path(d, "transforms_train.json").read_text())
    meta["frames"][0]["file_path"] = "train/r_000.jpg"
    Path(d, "transforms_train.json").write_text(json.dumps(meta))
    jc, tc = _configs(d, "finetune-nerf")
    js, ts = JScene.Scene(jc, shuffle=False), TScene.Scene(tc, shuffle=False)
    np.testing.assert_array_equal(ts.train_cameras[0].image, js.train_cameras[0].image)
    assert ts.train_cameras[0].alpha_mask is None
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="r_000.jpg: not a PNG, and Pillow"):
        TScene.Scene(tc)


def test_random_init_cloud_matches_jax():
    """The random init cloud (uniform in a cube of side 2·extent, random
    colours) from the same numpy generator: JAX's exactly."""
    got = TG.random_init_cloud(np.random.default_rng(4), n=500, extent=1.3)
    want = JG.random_init_cloud(np.random.default_rng(4), n=500, extent=1.3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32


def test_phong_vertex_colors_match_jax():
    """The generator's shading: Blinn-Phong vertex colours with area-weighted
    normals on a deformed icosphere, some faces invalid, from a camera
    centre: rel 1e-5 of JAX's (the same float32 operations; the normals'
    scatter sums in another order)."""
    from dgmesh_torch.ops import mesh_raster as TMR
    from dgmesh_tpu.ops import mesh_raster as JMR
    v, f = TSM.icosphere(2)
    v = TSM.deform_icosphere(v, 0.3)
    valid = np.random.default_rng(1).random(len(f)) < 0.9
    cam = np.array([2.0, -1.0, 1.5], np.float32)
    want = np.asarray(JMR.phong_vertex_colors(jnp.asarray(v), jnp.asarray(f),
                                              jnp.asarray(valid), jnp.asarray(cam)))
    got = TMR.phong_vertex_colors(torch.tensor(v), torch.tensor(f), torch.tensor(valid),
                                  cam).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert want.std() > 0.05
