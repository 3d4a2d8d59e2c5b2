"""Mesh and image files: OBJ, binary PLY meshes and PNG images.

A copy of ``dgmesh_tpu/utils_io.py`` (the reference exports meshes through
trimesh/open3d and images through imageio, train.py:323-423), with a PNG
codec of its own in place of Pillow: ``zlib`` and numpy.  The reader gives
the array ``np.asarray(PIL.Image.open(p))`` gives for every non-interlaced
PNG: each colour type and bit depth, every filter type (Pillow's modes
below).  The writer filters each row with "Up" (type 2) and writes 8-bit
grey, RGB, RGBA or, given a palette, palette images.  ``read_image`` reads
a file of another format through Pillow where Pillow imports.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# --- meshes -------------------------------------------------------------------


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray,
              vert_colors: np.ndarray = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        if vert_colors is not None:
            for v, c in zip(verts, vert_colors):
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def read_obj(path: str):
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                faces.append([int(x.split("/")[0]) - 1 for x in p[1:4]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def write_mesh_ply(path: str, verts: np.ndarray, faces: np.ndarray,
                   vert_colors: np.ndarray = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n, m = len(verts), len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if vert_colors is not None:
            hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        hdr += [f"element face {m}", "property list uchar int vertex_indices",
                "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if vert_colors is not None:
            vc = (np.clip(vert_colors, 0, 1) * 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = verts.astype("<f4")
            rec["rgb"] = vc
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        frec = np.zeros(m, dtype=[("n", "u1"), ("idx", "<i4", 3)])
        frec["n"] = 3
        frec["idx"] = faces.astype("<i4")
        f.write(frec.tobytes())


def read_mesh_ply(path: str):
    sizes = {"float": ("<f4", 4), "uchar": ("u1", 1), "int": ("<i4", 4), "double": ("<f8", 8)}
    with open(path, "rb") as f:
        n = m = 0
        vert_props = []
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element face"):
                m = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                vert_props.append(line.split()[1])
            elif line == "end_header":
                break
        dt = np.dtype([(f"p{j}", sizes[t][0]) for j, t in enumerate(vert_props)])
        rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        verts = np.stack([rec["p0"], rec["p1"], rec["p2"]], -1).astype(np.float32)
        frec = np.frombuffer(f.read(), dtype=np.dtype([("n", "u1"), ("idx", "<i4", 3)]),
                             count=m)
        faces = frec["idx"].astype(np.int32)
    return verts, faces


# --- PNG ----------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type → (channels, the bit depths the PNG spec allows)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, palette: np.ndarray = None):
    """uint8 (H,W), (H,W,1), (H,W,3) or (H,W,4) → an 8-bit PNG; with
    ``palette`` (N,3) uint8, ``img`` (H,W) holds its indices and the file is
    an 8-bit palette PNG (Pillow reads it as mode P)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    ch = 1 if a.ndim == 2 else a.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"write_png: {ch} channels")
    extra = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8).reshape(-1, 3)
        if ch != 1 or not 0 < len(pal) <= 256 or int(a.max(initial=0)) >= len(pal):
            raise ValueError(f"write_png: palette of {len(pal)} colours for indices of shape "
                             f"{a.shape} up to {int(a.max(initial=0))}")
        ctype, extra = 3, _chunk(b"PLTE", pal.tobytes())
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, w * ch)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]                # filter "Up", wrapping mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)))
        f.write(extra)
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9): None, Sub, Up, Average, Paeth;
    ``bpp`` is the filter's byte distance (1 below 8 bits a pixel), which
    divides ``stride``."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    rows = data[:h * (stride + 1)].reshape(h, stride + 1)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:                                # Sub: running sums per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ft == 2:
            cur = (line + prior) & 0xFF
        elif ft in (3, 4):                           # Average, Paeth: left to right
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if ft == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up, upleft))
                left = (cur[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                upleft = up
        else:
            raise ValueError(f"PNG: unknown filter type {ft}")
        out[y] = cur
        prior = cur.astype(np.int32)
    return out


def read_png(path: str) -> np.ndarray:
    """A non-interlaced PNG → the array ``np.asarray(PIL.Image.open(path))``
    gives (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(blob: bytes, path: str = "<bytes>") -> np.ndarray:
    """``read_png`` of a PNG file's bytes; ``path`` names it in errors.

    As Pillow's modes give them: grey at 8 bits (L) uint8 (H,W); at 1 bit
    (mode 1) bool; at 2 and 4 bits (L) uint8 scaled to 0-255 (×85, ×17);
    at 16 bits (I;16) uint16; a palette image (P, 1 to 8 bits) its indices,
    uint8 (H,W), the palette and any tRNS left aside; grey + alpha (LA)
    (H,W,2), RGB (H,W,3) and RGBA (H,W,4) uint8, at 16 bits their high
    bytes (grey + alpha at 16 bits as RGBA: L, L, L, A).  An interlaced
    (Adam7) file raises."""
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (n,) = struct.unpack(">I", blob[pos:pos + 4])
        tag, data = blob[pos + 4:pos + 8], blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1]:
        raise ValueError(f"{path}: not a valid PNG (bit depth {depth}, colour type {ctype})")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not read (colour type {ctype}, "
                         f"bit depth {depth}); save it without interlacing")
    ch = _COLOUR_TYPES[ctype][0]
    bits = depth * ch
    stride = (w * bits + 7) // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(data, h, stride, max(bits // 8, 1))
    if depth == 16:
        if ctype == 0:                              # I;16: the samples as they are
            return rows.view(">u2").astype(np.uint16).reshape(h, w)
        img = rows[:, 0::2].reshape(h, w, ch)       # RGB;16B and the like: high bytes
        if ctype == 4:                              # LA;16B: Pillow gives RGBA (L, L, L, A)
            img = img[..., [0, 0, 0, 1]]
    elif depth < 8:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)   # the first pixel is high
        v = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, stride * per_byte)
        v = v[:, :w]
        if ctype == 3:
            return v
        return v.astype(bool) if depth == 1 else (v * (255 // ((1 << depth) - 1))).astype(
            np.uint8)
    else:
        img = rows.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def read_image(path: str) -> np.ndarray:
    """An image file as ``np.asarray(PIL.Image.open(path))``: a PNG by the
    port's own reader; any other format (a JPEG of a Colmap scene, say)
    through Pillow, which raises naming the file where Pillow is not
    installed."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == _PNG_SIG:
        return decode_png(blob, path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ValueError(f"{path}: not a PNG, and Pillow, which would read it, is not "
                         f"installed ({e})") from e
    with Image.open(path) as im:
        return np.asarray(im)


def save_image(path: str, img: np.ndarray):
    """float image in [0, 1] (clipped) → 8-bit PNG, as Pillow would write it."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
