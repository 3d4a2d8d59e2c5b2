"""The port's real-capture data path against the JAX package's and Pillow:
the eight dataset readers and ``Scene`` on the fixtures of
tests/torch_capture_fixtures.py (cameras, images, masks and point clouds
exactly), the PNG reader without Pillow against
``np.asarray(PIL.Image.open(p))`` on every colour type, bit depth and
filter type, interlaced or not, PNGs read through Pillow where it imports,
``lanczos_resize`` against Pillow's LANCZOS value for value, and reading
every PNG dataset without Pillow."""

import io
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from torch_capture_fixtures import FIXTURES, build_png, write_fixture

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch import utils_io as TIO  # noqa: E402
from dgmesh_torch.config import Config as TConfig  # noqa: E402
from dgmesh_torch.data import readers as TR  # noqa: E402
from dgmesh_torch.data import scene as TScene  # noqa: E402
from dgmesh_torch.data.resize import lanczos_resize  # noqa: E402
from dgmesh_tpu.config import Config as JConfig  # noqa: E402
from dgmesh_tpu.data import readers as JR  # noqa: E402
from dgmesh_tpu.data import scene as JScene  # noqa: E402

FIELDS = ("uid", "fovx", "fovy", "fid", "width", "height", "image_name")
ARRAYS = ("R", "T", "K", "image", "alpha_mask", "orig_transform", "mesh_verts", "mesh_faces")


def assert_same_cameras(got, want):
    """Count, order and every field of each camera exactly, dtypes too."""
    assert [c.image_name for c in got] == [c.image_name for c in want]
    for a, b in zip(got, want):
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        for f in ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if y is not None:
                np.testing.assert_array_equal(x, y, err_msg=f)
                assert np.asarray(x).dtype == np.asarray(y).dtype, f


def assert_same_cloud(got, want):
    for f in ("points", "colors", "normals"):
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), f
        if y is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)
            assert x.dtype == y.dtype, f


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    return {k: write_fixture(k, root / k.replace(" ", "_").replace("(", "").replace(")", ""),
                             seed=i) for i, k in enumerate(FIXTURES)}


# the reader of each fixture, with the arguments Scene gives it
READERS = {
    "Colmap": ("read_colmap_scene", dict(eval_split=True, llffhold=2)),
    "Colmap (text)": ("read_colmap_scene", dict(white_background=True)),
    "Blender": ("read_blender_scene", dict(white_background=True, downsample=2.0)),
    "DTU": ("read_dtu_scene", {}),
    "Nerfies": ("read_nerfies_scene", dict(white_background=True, nerfies_ratio=0.5)),
    "iPhone": ("read_iphone_scene", dict(white_background=False)),
    "NeuralActor": ("read_neural_actor_scene", dict(white_background=True)),
    "PlenopticVideo": ("read_plenoptic_scene", dict(num_images=2, hold_id=(1,))),
}


@pytest.mark.parametrize("kind", list(READERS))
def test_reader_matches_jax(fixtures, kind):
    """Each reader on its fixture, the port's and JAX's: the cameras of both
    splits, in order, with every pose, intrinsic, time, size, image and
    mask exactly (Blender's at downsample 2: Pillow's LANCZOS values), the
    NeRF++ normalisation and the point cloud (numpy's global generator
    seeded alike before each, for the Nerfies and iPhone colours)."""
    name, kw = READERS[kind]
    infos = []
    for mod in (TR, JR):
        np.random.seed(11)
        infos.append(getattr(mod, name)(fixtures[kind], **kw))
    got, want = infos
    assert len(want.train_cameras) > 1
    assert_same_cameras(got.train_cameras, want.train_cameras)
    assert_same_cameras(got.test_cameras, want.test_cameras)
    assert_same_cloud(got.point_cloud, want.point_cloud)
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    assert got.ply_path == want.ply_path
    if kind == "Blender":
        assert want.train_cameras[0].image.shape == (12, 20, 3)


def test_masked_readers_see_palette_and_sam_masks(fixtures):
    """The masks land where the fixtures put them: DEVA's palette indices
    (1- and 8-bit), SAM's L and 1-bit masks and RGB label images all give
    the same object, and the background takes its colour outside it."""
    np.random.seed(0)
    for kind, bg in (("Nerfies", 1.0), ("iPhone", 0.0), ("NeuralActor", 1.0)):
        name, kw = READERS[kind]
        info = getattr(TR, name)(fixtures[kind], **kw)
        for cam in info.train_cameras + info.test_cameras:
            m = cam.alpha_mask[..., 0]
            assert m[4:20, 6:31].all() and m.sum() == 16 * 25, (kind, cam.image_name)
            assert (cam.image[m == 0] == bg).all()


# --- Scene ----------------------------------------------------------------------------

DATA_TYPES = {"Colmap": "", "Colmap (text)": "Colmap", "Blender": "", "DTU": "DTU",
              "Nerfies": "Nerfies", "iPhone": "iPhone", "NeuralActor": "NeuralActor",
              "PlenopticVideo": ""}


def _configs(path, data_type, **model):
    out = []
    for C in (TConfig, JConfig):
        c = C()
        c.model.source_path, c.model.data_type, c.model.eval = path, data_type, True
        for k, v in model.items():
            setattr(c.model, k, v)
        out.append(c)
    return out


def _scenes(path, data_type, **model):
    out = []
    for cfg, S in zip(_configs(path, data_type, **model), (TScene, JScene)):
        np.random.seed(3)
        out.append(S.Scene(cfg, shuffle=True, seed=6666))
    return out


@pytest.mark.parametrize("kind", list(DATA_TYPES))
def test_scene_matches_jax(fixtures, kind):
    """Scene under each data_type (or sniffed from the folder), the port's
    and JAX's: the reader's arguments, the shuffled training order, every
    camera, the extent and the point cloud, exactly."""
    ts, js = _scenes(fixtures[kind], DATA_TYPES[kind], white_background=True)
    assert TScene.detect_scene_type(fixtures[kind], DATA_TYPES[kind]) == \
        JScene.detect_scene_type(fixtures[kind], DATA_TYPES[kind])
    assert_same_cameras(ts.train_cameras, js.train_cameras)
    assert_same_cameras(ts.test_cameras, js.test_cameras)
    assert_same_cloud(ts.point_cloud, js.point_cloud)
    assert ts.cameras_extent == js.cameras_extent and ts.time_interval == js.time_interval


@pytest.mark.parametrize("kind", ["Nerfies", "NeuralActor", "Blender"])
def test_scene_resolution_2_matches_jax(fixtures, kind):
    """resolution 2: every image and mask through Pillow's LANCZOS (JAX) and
    lanczos_resize (the port), equal value for value; K's first two rows
    halved."""
    ts, js = _scenes(fixtures[kind], DATA_TYPES[kind], resolution=2, white_background=True)
    assert_same_cameras(ts.train_cameras, js.train_cameras)
    assert_same_cameras(ts.test_cameras, js.test_cameras)
    cam = ts.train_cameras[0]
    assert (cam.width, cam.height) == (20, 12) and cam.image.shape == (12, 20, 3)
    if kind != "Blender":
        raw = TScene.Scene(_configs(fixtures[kind], DATA_TYPES[kind])[0], shuffle=True,
                           seed=6666).train_cameras[0]
        np.testing.assert_array_equal(cam.K[:2], raw.K[:2] * np.float32(0.5))


def test_scene_resolution_minus_one_scales_wide_frames_to_1600(tmp_path):
    """resolution -1 on frames 1700 wide: 1600 × round(12 / 1.0625), the
    port's and JAX's alike."""
    from torch_capture_fixtures import blender
    blender(str(tmp_path), np.random.default_rng(5), width=1700, height=12, n=(1, 1))
    ts, js = _scenes(str(tmp_path), "", resolution=-1)
    assert_same_cameras(ts.train_cameras, js.train_cameras)
    assert (ts.train_cameras[0].width, ts.train_cameras[0].height) == (1600, 11)


# --- PNG ------------------------------------------------------------------------------

# (colour type, bit depth, Pillow's mode)
PNG_MODES = [(3, 1, "P"), (3, 2, "P"), (3, 4, "P"), (3, 8, "P"), (0, 1, "1"), (0, 2, "L"),
             (0, 4, "L"), (0, 8, "L"), (0, 16, "I;16"), (4, 8, "LA"), (4, 16, "RGBA"),
             (2, 8, "RGB"), (2, 16, "RGB"), (6, 8, "RGBA"), (6, 16, "RGBA")]


@pytest.mark.parametrize("ctype,depth,mode", PNG_MODES, ids=lambda v: str(v))
def test_png_reader_matches_pillow(ctype, depth, mode):
    """Hand-built PNGs of each colour type and bit depth, their rows
    filtered None, Sub, Up, Average and Paeth in turn, at widths whose rows
    end inside a byte: the port's array is Pillow's (values, dtype, shape);
    a palette image with a tRNS chunk too."""
    rng = np.random.default_rng(ctype * 100 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((7, 13), (11, 5)):
        samples = rng.integers(0, 1 << depth, (h, w) if ch == 1 else (h, w, ch))
        pal = rng.integers(0, 256, 3 << depth) if ctype == 3 else None
        for trns in ((None, bytes([255, 0, 128])) if ctype == 3 else (None,)):
            blob = build_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4, 4, 3, 1),
                             palette=pal, trns=trns)
            im = Image.open(io.BytesIO(blob))
            assert im.mode == mode
            want = np.asarray(im)
            got = TIO.decode_png(blob)
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ctype,depth,mode", PNG_MODES, ids=lambda v: str(v))
def test_interlaced_png_reader_matches_pillow(ctype, depth, mode, tmp_path):
    """Adam7-interlaced PNGs of each colour type and bit depth, each pass's
    rows filtered None, Sub, Up, Average and Paeth in turn, at 1x1 (six
    empty passes), 3x5, 9x17 and 33x20: ``decode_png`` (the path without
    Pillow) gives Pillow's array (values, dtype, shape), and ``read_png``
    (through Pillow) the same."""
    rng = np.random.default_rng(ctype * 100 + depth + 1)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in ((1, 1), (3, 5), (9, 17), (33, 20)):
        samples = rng.integers(0, 1 << depth, (h, w) if ch == 1 else (h, w, ch))
        pal = rng.integers(0, 256, 3 << depth) if ctype == 3 else None
        blob = build_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4, 4, 3, 1),
                         palette=pal, interlace=1)
        im = Image.open(io.BytesIO(blob))
        assert im.mode == mode and im.info.get("interlace") == 1
        want = np.asarray(im)
        got = TIO.decode_png(blob)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        p = tmp_path / f"{h}x{w}.png"
        p.write_bytes(blob)
        np.testing.assert_array_equal(TIO.read_png(str(p)), want)


def _frame(h, w, seed):
    """A smooth RGB ramp with noise, as a camera frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 37.0) * 80 + np.cos(yy / 23.0) * 60 + 120 + 10 * c
                     for c in range(3)], -1)
    return np.clip(base + rng.integers(0, 20, base.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name,ft", [("Paeth", 4), ("Average", 3)])
def test_png_reader_reads_a_paeth_or_average_frame_as_pillow(name, ft):
    """A 540x960 RGB frame with every row Paeth, or every row Average (the
    filters whose rows run left to right): ``decode_png`` gives the frame
    back, equal to Pillow's array."""
    img = _frame(540, 960, ft)
    blob = build_png(img, 8, 2, filters=(ft,))
    got = TIO.decode_png(blob)
    np.testing.assert_array_equal(got, np.asarray(Image.open(io.BytesIO(blob))))
    np.testing.assert_array_equal(got, img)


def test_png_goes_through_pillow_where_it_imports(tmp_path, monkeypatch):
    """``read_png`` and ``read_image`` open a PNG with Pillow (JAX's call)
    where Pillow imports, and never call ``decode_png``; with PIL blocked
    they call ``decode_png``.  Both give the same array."""
    img = _frame(19, 23, 5)
    p = tmp_path / "f.png"
    p.write_bytes(build_png(img, 8, 2, filters=(4, 3, 1), interlace=1))
    calls = []
    decode, pil_open = TIO.decode_png, Image.open
    monkeypatch.setattr(TIO, "decode_png", lambda *a: calls.append("decode_png") or decode(*a))
    monkeypatch.setattr(Image, "open", lambda *a: calls.append("Pillow") or pil_open(*a))
    with_pil = [TIO.read_png(str(p)), TIO.read_image(str(p))]
    assert calls == ["Pillow", "Pillow"]
    monkeypatch.setitem(sys.modules, "PIL", None)
    without = [TIO.read_png(str(p)), TIO.read_image(str(p))]
    assert calls == ["Pillow", "Pillow", "decode_png", "decode_png"]
    for a in with_pil + without:
        np.testing.assert_array_equal(a, img)


def test_png_writer_palette_is_read_as_indices_by_both(tmp_path):
    """write_png with a palette: Pillow opens mode P with that palette, and
    both readers give the indices back."""
    idx = np.random.default_rng(1).integers(0, 3, (9, 14)).astype(np.uint8)
    pal = np.array([[0, 0, 0], [128, 0, 0], [0, 128, 0]], np.uint8)
    p = str(tmp_path / "m.png")
    TIO.write_png(p, idx, palette=pal)
    im = Image.open(p)
    assert im.mode == "P" and im.getpalette()[:9] == pal.reshape(-1).tolist()
    np.testing.assert_array_equal(np.asarray(im), idx)
    np.testing.assert_array_equal(TIO.read_png(p), idx)
    with pytest.raises(ValueError, match="palette"):
        TIO.write_png(p, idx + 3, palette=pal)


# --- LANCZOS --------------------------------------------------------------------------

RESIZES = [((37, 53), (20, 17)), ((37, 53, 3), (91, 70)), ((48, 64, 4), (32, 24)),
           ((31, 29, 2), (14, 40)), ((17, 23, 3), (23, 40)), ((40, 64, 3), (64, 20)),
           ((5, 7), (3, 2)), ((64, 48, 4), (151, 97)), ((100, 100, 3), (33, 33)),
           ((1, 9, 3), (4, 1)), ((12, 1700, 3), (1600, 11))]


@pytest.mark.parametrize("shape,size", RESIZES, ids=lambda v: str(v))
def test_lanczos_resize_equals_pillow(shape, size):
    """Random uint8 images (L, LA, RGB, RGBA; alpha with 0, 255 and partial
    values), down and up, odd sizes, one axis unchanged: every value equal
    to Pillow's Image.resize(size, LANCZOS).  No exception."""
    rng = np.random.default_rng(sum(shape) + sum(size))
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    if len(shape) == 3 and shape[2] in (2, 4):
        a[..., -1] = rng.choice([0, 255, 7, 128, 200], shape[:2])
    want = np.asarray(Image.fromarray(a).resize(size, Image.LANCZOS))
    got = lanczos_resize(a, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_lanczos_resize_refuses_what_pillow_would_not_resize_so():
    with pytest.raises(ValueError, match="uint8"):
        lanczos_resize(np.zeros((4, 4), np.uint16), (2, 2))
    with pytest.raises(ValueError, match="uint8"):
        lanczos_resize(np.zeros((4, 4, 5), np.uint8), (2, 2))


# --- without Pillow -------------------------------------------------------------------

def test_png_datasets_read_without_pillow(fixtures):
    """A fresh interpreter with PIL blocked reads every PNG fixture through
    the port's Scene (Blender at downsample 2 and resolution 2 too) and
    never imports PIL; a JPEG frame (the text Colmap model's) raises naming
    the file."""
    paths = {k: v for k, v in fixtures.items() if k != "Colmap (text)"}
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        sys.modules["PIL"] = None
        from dgmesh_torch.config import Config
        from dgmesh_torch.data.scene import Scene
        paths, types = {paths!r}, {DATA_TYPES!r}
        for kind, path in paths.items():
            for res, ds in ((1, 1.0), (2, 2.0)):
                cfg = Config()
                cfg.model.source_path, cfg.model.data_type = path, types[kind]
                cfg.model.resolution, cfg.model.downsample = res, ds
                s = Scene(cfg)
                assert len(s.train_cameras) > 1, kind
        assert sys.modules["PIL"] is None and "PIL.Image" not in sys.modules
        cfg = Config()
        cfg.model.source_path = {fixtures["Colmap (text)"]!r}
        try:
            Scene(cfg)
        except ValueError as e:
            assert "im_2.jpg" in str(e) and "Pillow" in str(e), e
        else:
            raise AssertionError("a JPEG read without Pillow")
        print("ok")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=str(ROOT))
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr


def test_colmap_points3d_bin_matches_jax(fixtures):
    """points3D.bin walked over its bytes: JAX's parse (native or struct)
    exactly."""
    from dgmesh_torch.data import colmap as TC
    from dgmesh_tpu.data import colmap as JC
    sparse = os.path.join(fixtures["Colmap"], "sparse", "0")
    for a, b in zip(TC.read_points3d(sparse), JC.read_points3d(sparse)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and len(a) == 50
