"""Small fixtures in the on-disk layouts of the eight dataset readers,
written with Pillow and numpy, for the parity tests of the port's readers
against the JAX package's (both read the same folder).  They follow the
layouts of tests/test_readers.py with what real captures add: rotated and
off-centre cameras, DEVA's palette masks, SAM's greyscale and 1-bit masks,
RGBA frames, COLMAP's binary and text models and a JPEG frame.

``build_png`` writes a PNG of any colour type and bit depth with the given
row filters, independently of both packages' writers."""

import json
import os
import struct
import zlib

import numpy as np
from PIL import Image

H, W = 24, 40          # frames of the fixtures (not a multiple of 16 wide)


# --- PNG files built by hand --------------------------------------------------------

def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """(H, N) samples → (H, stride) bytes: the first sample in the high bits
    of a byte below 8 bits, big-endian at 16."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.concatenate([samples, np.zeros((h, -n % per), samples.dtype)], 1).reshape(h, -1, per)
    return (s.astype(np.int64) << np.arange(8 - depth, -1, -depth)).sum(-1).astype(np.uint8)


def _filter_rows(rows, bpp, filters, first=0):
    """Row y filtered with filters[(first + y) % len(filters)] (PNG spec §9)."""
    rows = rows.astype(np.int32)
    out = []
    for y, cur in enumerate(rows):
        ft = filters[(first + y) % len(filters)]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
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
    return b"".join(out)


# Adam7 (PNG spec §8.2): each pass's first row and column, row and column steps
ADAM7 = [(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1)]


def build_png(samples, depth, ctype, filters=(0, 1, 2, 3, 4), palette=None, trns=None,
              interlace=0):
    """PNG bytes of ``samples`` (H,W) or (H,W,C) at ``depth`` bits, colour
    type ``ctype``; ``palette`` a PLTE's (N*3,) bytes, ``trns`` a tRNS
    chunk's.  With ``interlace`` 1 the image data is Adam7's seven passes,
    each a sub-image with rows, packing and filter bytes of its own (an
    empty pass has none); the filters run on from one pass's rows to the
    next."""
    h, w = samples.shape[:2]
    ch = 1 if samples.ndim == 2 else samples.shape[2]
    bpp = max(depth * ch // 8, 1)
    data, first = [], 0
    for y0, x0, dy, dx in (ADAM7 if interlace else [(0, 0, 1, 1)]):
        sub = samples[y0::dy, x0::dx]
        ph, pw = sub.shape[:2]
        if ph == 0 or pw == 0:
            continue
        data.append(_filter_rows(_pack_rows(sub.reshape(ph, pw * ch), depth), bpp, filters,
                                 first))
        first += ph
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    body += _chunk(b"IDAT", zlib.compress(b"".join(data)))
    return b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b"")


# --- images and masks ---------------------------------------------------------------

def _save(path, im, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    im.save(path, **kw)


def rgb(path, rng, alpha=False):
    ch = 4 if alpha else 3
    a = rng.integers(0, 256, (H, W, ch), dtype=np.uint8)
    if alpha:
        a[..., 3] = rng.choice([0, 255, 90, 180], (H, W))
    _save(path, Image.fromarray(a))


def _blob():
    m = np.zeros((H, W), bool)
    m[4:20, 6:31] = True
    return m


def deva_mask(path, bits=8):
    """A palette PNG: index 1 (DEVA's first object) on the object, 0 off."""
    im = Image.frombytes("P", (W, H), _blob().astype(np.uint8).tobytes())
    im.putpalette([0, 0, 0, 128, 0, 0] + [0] * 762)
    _save(path, im, bits=bits)


def label_mask(path):
    """DEVA's RGB label image."""
    m = np.zeros((H, W, 3), np.uint8)
    m[_blob()] = (128, 0, 0)
    _save(path, Image.fromarray(m))


def sam_mask(path, one_bit=False):
    """SAM's masks: L (0 / 255) or 1-bit."""
    m = _blob()
    _save(path, Image.fromarray(m) if one_bit else Image.fromarray(m.astype(np.uint8) * 255))


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _look_at_opencv(rng, radius=3.0):
    """An OpenCV w2c rotation and camera centre looking at the origin."""
    c = rng.normal(size=3)
    c = c / np.linalg.norm(c) * radius
    z = -c / np.linalg.norm(c)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z]), c


# --- the layouts --------------------------------------------------------------------

def nerfies(root, rng, iphone=False):
    ids = [f"{i:03d}" if not iphone else f"0_{i:05d}" for i in range(5)]
    ratio_dir = "1x" if iphone else "2x"
    scale = 1.0 if iphone else 0.5
    if not iphone:
        with open(os.path.join(root, "scene.json"), "w") as f:
            json.dump(dict(scale=1.7, center=[0.1, -0.2, 0.3]), f)
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump(dict(train_ids=ids[:3] + ids[4:], val_ids=ids[3:4]), f)
    meta = {i: (dict(warp_id=2 * k) if iphone else dict(time_id=k, warp_id=k))
            for k, i in enumerate(ids)}
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump(meta, f)
    os.makedirs(os.path.join(root, "camera"), exist_ok=True)
    for k, i in enumerate(ids):
        rot, c = _look_at_opencv(rng)
        with open(os.path.join(root, "camera", i + ".json"), "w") as f:
            json.dump(dict(orientation=rot.tolist(), position=c.tolist(),
                           focal_length=float(rng.uniform(60, 90)) / scale,
                           principal_point=[0.53 * W / scale, 0.46 * H / scale],
                           image_size=[W / scale, H / scale]), f)
        rgb(os.path.join(root, "rgb", ratio_dir, i + ".png"), rng)
        mpath = os.path.join(root, "mask-tracking", ratio_dir, "Annotations", i + ".png")
        if iphone:
            sam_mask(mpath, one_bit=k % 2 == 1)
        else:
            deva_mask(mpath, bits=(1, 8)[k % 2])
    np.save(os.path.join(root, "points.npy"), rng.normal(size=(90, 3)))


def neural_actor(root, rng):
    for split, n in (("train", 3), ("test", 2)):
        sub = "training" if split == "train" else "testing"
        frames = []
        for k in range(n):
            rot, c = _look_at_opencv(rng)
            c2w = np.eye(4)
            c2w[:3, :3], c2w[:3, 3] = rot.T, c
            K = [[80.0 + k, 0, 0.55 * W], [0, 81.0, 0.45 * H], [0, 0, 1]]
            rel = f"{sub}/cam0{k}/{k:04d}.png"
            frames.append(dict(transform_matrix=c2w.tolist(), intrinsic=K,
                               time=k / max(n - 1, 1), file_path=rel))
            rgb(os.path.join(root, rel), rng)
            mpath = os.path.join(root, f"{sub}_mask", "Annotations", f"cam0{k}", f"{k:04d}.png")
            deva_mask(mpath) if k % 2 == 0 else label_mask(mpath)
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(frames=frames), f)


def dtu(root, rng):
    n = 3
    cams = {}
    for i in range(n):
        K = np.array([[70.0, 0.3, 0.52 * W], [0, 72.0, 0.47 * H], [0, 0, 1]])
        rot, c = _look_at_opencv(rng)
        P = np.eye(4)
        P[:3, :4] = K @ np.concatenate([rot, -(rot @ c)[:, None]], 1)
        S = np.eye(4)
        S[:3, :3] *= 1.5
        S[:3, 3] = [0.1, 0.0, -0.2]
        cams[f"world_mat_{i}"] = P
        cams[f"scale_mat_{i}"] = S
        cams[f"fid_{i}"] = np.asarray(float(i))
    np.savez(os.path.join(root, "cameras_sphere.npz"), **cams)
    for i in range(n):
        rgb(os.path.join(root, "image", f"{i:03d}.png"), rng)
        label_mask(os.path.join(root, "mask", f"{i:03d}.png")) if i % 2 else \
            sam_mask(os.path.join(root, "mask", f"{i:03d}.png"))


def plenoptic(root, rng):
    n_cams = 3
    poses = np.zeros((n_cams, 3, 5))
    for i in range(n_cams):
        rot, c = _look_at_opencv(rng)
        poses[i, :, :4] = np.concatenate([rot.T, c[:, None]], 1)
        poses[i, :, 4] = [H, W, 70.0]
    pb = np.concatenate([poses.reshape(n_cams, 15), np.ones((n_cams, 2))], 1)
    np.save(os.path.join(root, "poses_bounds.npy"), pb)
    for i in range(n_cams):
        for k in range(3):
            rgb(os.path.join(root, "frames", f"cam{i:02d}", f"{k:04d}.png"), rng)


def _qvec(rot):
    """A unit quaternion (w, x, y, z) of a rotation matrix."""
    w = np.sqrt(max(1.0 + np.trace(rot), 1e-12)) / 2
    return np.array([w, (rot[2, 1] - rot[1, 2]) / (4 * w), (rot[0, 2] - rot[2, 0]) / (4 * w),
                     (rot[1, 0] - rot[0, 1]) / (4 * w)])


def colmap(root, rng, binary=True):
    """sparse/0 with two cameras (PINHOLE, SIMPLE_RADIAL), four images (one
    a JPEG in the text model) and 50 points, as .bin or .txt."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    cams = [(1, 1, "PINHOLE", [75.0, 77.0, 0.5 * W, 0.5 * H]),
            (2, 2, "SIMPLE_RADIAL", [70.0, 0.5 * W, 0.5 * H, 0.01])]
    images = []
    for i in range(4):
        rot = _look_at_opencv(rng)[0] if i else _rotation(rng)
        ext = ".jpg" if (i == 2 and not binary) else ".png"
        images.append((i + 1, _qvec(rot), rng.normal(size=3), 1 + i % 2, f"im_{i}{ext}"))
        path = os.path.join(root, "images", f"im_{i}{ext}")
        if ext == ".jpg":
            _save(path, Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)),
                  quality=90)
        else:
            rgb(path, rng)
    xyz = rng.normal(size=(50, 3))
    col = rng.integers(0, 256, (50, 3))
    if binary:
        with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(cams)))
            for cid, mid, _, params in cams:
                f.write(struct.pack("<iiQQ", cid, mid, W, H) + struct.pack(f"<{len(params)}d",
                                                                         *params))
        with open(os.path.join(sparse, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(images)))
            for iid, q, t, cid, name in images:
                f.write(struct.pack("<i4d3di", iid, *q, *t, cid) + name.encode() + b"\0")
                f.write(struct.pack("<Q", 2) + struct.pack("<ddqddq", 1.0, 2.0, -1, 3.0, 4.0, 7))
        with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(xyz)))
            for j, (p, c) in enumerate(zip(xyz, col)):
                track = rng.integers(0, 5, (j % 4, 2))
                f.write(struct.pack("<Q3d3Bd", j, *p, *c, 0.5) + struct.pack("<Q", len(track))
                        + track.astype("<i4").tobytes())
    else:
        with open(os.path.join(sparse, "cameras.txt"), "w") as f:
            f.write("# camera list\n")
            for cid, _, model, params in cams:
                f.write(f"{cid} {model} {W} {H} {' '.join(repr(p) for p in params)}\n")
        with open(os.path.join(sparse, "images.txt"), "w") as f:
            f.write("# image list\n")
            for iid, q, t, cid, name in images:
                f.write(f"{iid} {' '.join(repr(float(v)) for v in (*q, *t))} {cid} {name}\n"
                        "1.0 2.0 -1 3.0 4.0 7\n")
        with open(os.path.join(sparse, "points3D.txt"), "w") as f:
            f.write("# points\n")
            for j, (p, c) in enumerate(zip(xyz, col)):
                f.write(f"{j} {' '.join(repr(float(v)) for v in p)} {c[0]} {c[1]} {c[2]} 0.5 "
                        "1 0 2 1\n")


def blender(root, rng, width=W, height=H, n=(3, 2)):
    """D-NeRF transforms with RGBA frames (partial alpha) and no points3d.ply."""
    for split, m in zip(("train", "test"), n):
        frames = []
        for k in range(m):
            c2w = np.eye(4)
            c2w[:3, :3] = _rotation(rng)
            c2w[:3, 3] = rng.normal(size=3) * 3
            frames.append(dict(file_path=f"{split}/r_{k:03d}", transform_matrix=c2w.tolist(),
                               time=k / max(m - 1, 1)))
            a = rng.integers(0, 256, (height, width, 4), dtype=np.uint8)
            a[..., 3] = rng.choice([0, 255, 90, 180], (height, width))
            _save(os.path.join(root, split, f"r_{k:03d}.png"), Image.fromarray(a))
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump(dict(camera_angle_x=0.7, frames=frames), f)


FIXTURES = {"Colmap": lambda r, g: colmap(r, g, True),
            "Colmap (text)": lambda r, g: colmap(r, g, False),
            "Blender": blender,
            "DTU": dtu,
            "Nerfies": nerfies,
            "iPhone": lambda r, g: nerfies(r, g, iphone=True),
            "NeuralActor": neural_actor,
            "PlenopticVideo": plenoptic}


def write_fixture(kind, root, seed=0):
    """Write the fixture of ``kind`` (a key of FIXTURES) under ``root``."""
    os.makedirs(root, exist_ok=True)
    FIXTURES[kind](str(root), np.random.default_rng(seed))
    return str(root)
