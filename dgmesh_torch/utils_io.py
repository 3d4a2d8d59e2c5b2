"""Mesh and image files: OBJ, binary PLY meshes and PNG images.

A copy of ``dgmesh_tpu/utils_io.py`` (the reference exports meshes through
trimesh/open3d and images through imageio, train.py:323-423).  An image is
read as JAX's readers read it, ``np.asarray(PIL.Image.open(p))``, through
Pillow where Pillow imports; without Pillow a PNG goes to the port's own
reader, ``decode_png`` (``zlib`` and numpy), which gives the same array for
every PNG: each colour type and bit depth, every filter type, interlaced or
not (Pillow's modes below).  The writer filters each row with "Up" (type
2) and writes 8-bit grey, RGB, RGBA or, given a palette, palette images.
"""

from __future__ import annotations

import io
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


# Adam7's seven passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
          (1, 0, 2, 1))


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec §9) of ``rows`` (h, 1 + stride):
    each row's filter byte, then its bytes.  ``bpp`` is the filter's byte
    distance (1 below 8 bits a pixel), which divides the stride."""
    ft = rows[:, 0]
    if ft.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown filter type {int(ft.max())}")
    if (ft >= 3).any():
        return _unfilter_diagonals(rows[:, 1:], ft, bpp)
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):                           # None, Sub and Up: a row at a time
        f, line = ft[y], rows[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 1:                             # Sub: running sums per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        else:
            cur = (line + prior) & 0xFF
        out[y] = cur
        prior = cur
    return out


def _unfilter_diagonals(raw: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """``_unfilter`` of a file with Average or Paeth rows.  Pixel (y, x)
    (``bpp`` bytes) depends on (y, x-1), (y-1, x) and (y-1, x-1), so every
    pixel on one anti-diagonal y + x = d is found in one vector step, whatever
    its row's filter: h + n - 1 steps for n pixels a row.  The bytes are kept
    skewed, diagonal-major: row y of diagonal d at ``diag[d + 2, y + 1]``,
    with a zero diagonal and a zero row before the first ones."""
    h, n = raw.shape[0], raw.shape[1] // bpp
    y, x = np.ogrid[:h, :n]
    skew = np.zeros((h + n - 1, h, bpp), np.uint8)
    skew[y + x, y] = raw.reshape(h, n, bpp)
    diag = np.zeros((h + n + 1, h + 1, bpp), np.uint8)
    kinds = ft[:, None]
    for d in range(h + n - 1):
        lo, hi = max(0, d - n + 1), min(h, d + 1)
        left = diag[d + 1, lo + 1:hi + 1].astype(np.int16)
        up = diag[d + 1, lo:hi].astype(np.int16)
        upleft = diag[d, lo:hi].astype(np.int16)
        pa, pb = np.abs(up - upleft), np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        k = kinds[lo:hi]
        pred = np.where(k == 4, paeth, np.where(k == 3, (left + up) >> 1, np.where(
            k == 2, up, np.where(k == 1, left, 0))))
        diag[d + 2, lo + 1:hi + 1] = skew[d, lo:hi] + pred.astype(np.uint8)   # mod 256
    return diag[y + x + 2, y + 1].reshape(h, n * bpp)


def _scanlines(data: np.ndarray, pos: int, h: int, w: int, bits: int, path: str):
    """The unfiltered (h, stride) bytes of an h x w image at ``bits`` a pixel
    that starts at ``data[pos]``, and the position after it."""
    stride = (w * bits + 7) // 8
    end = pos + h * (stride + 1)
    if len(data) < end:
        raise ValueError(f"{path}: the image data ends early ({len(data)} of {end} bytes)")
    return _unfilter(data[pos:end].reshape(h, stride + 1), max(bits // 8, 1)), end


def _samples(rows: np.ndarray, w: int, depth: int, ctype: int) -> np.ndarray:
    """Unfiltered bytes (h, stride) → Pillow's array (``decode_png``)."""
    h, ch = rows.shape[0], _COLOUR_TYPES[ctype][0]
    if depth == 16:
        if ctype == 0:                              # I;16: the samples as they are
            return rows.view(">u2").astype(np.uint16).reshape(h, w)
        img = rows[:, 0::2].reshape(h, w, ch)       # RGB;16B and the like: high bytes
        if ctype == 4:                              # LA;16B: Pillow gives RGBA (L, L, L, A)
            img = img[..., [0, 0, 0, 1]]
    elif depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)   # the first pixel is high
        v = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        if ctype == 3:
            return v
        return v.astype(bool) if depth == 1 else (v * (255 // ((1 << depth) - 1))).astype(
            np.uint8)
    else:
        img = rows.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def _pillow_image():
    """Pillow's ``Image`` module, or None where Pillow does not import."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def read_png(path: str) -> np.ndarray:
    """A PNG file → ``np.asarray(PIL.Image.open(path))``, JAX's call: through
    Pillow where it imports, else ``decode_png``.  A file that is no PNG
    raises, naming it."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    return png_array(blob, path)


def png_array(blob: bytes, path: str = "<bytes>") -> np.ndarray:
    """A PNG file's bytes → ``np.asarray(PIL.Image.open(...))``: through
    Pillow where it imports, else ``decode_png``."""
    Image = _pillow_image()
    if Image is None:
        return decode_png(blob, path)
    with Image.open(io.BytesIO(blob)) as im:
        return np.asarray(im)


def decode_png(blob: bytes, path: str = "<bytes>") -> np.ndarray:
    """The port's own PNG reader, for a machine without Pillow: a PNG file's
    bytes → the array ``np.asarray(PIL.Image.open(...))`` gives; ``path``
    names the file in errors.

    As Pillow's modes give them: grey at 8 bits (L) uint8 (H,W); at 1 bit
    (mode 1) bool; at 2 and 4 bits (L) uint8 scaled to 0-255 (×85, ×17);
    at 16 bits (I;16) uint16; a palette image (P, 1 to 8 bits) its indices,
    uint8 (H,W), the palette and any tRNS left aside; grey + alpha (LA)
    (H,W,2), RGB (H,W,3) and RGBA (H,W,4) uint8, at 16 bits their high
    bytes (grey + alpha at 16 bits as RGBA: L, L, L, A).  Every filter type,
    and Adam7-interlaced files: each pass a sub-image of its own, unfiltered
    and unpacked, then scattered into the image."""
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
    if ctype not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[ctype][1] or interlace > 1:
        raise ValueError(f"{path}: not a valid PNG (bit depth {depth}, colour type {ctype}, "
                         f"interlace method {interlace})")
    bits = depth * _COLOUR_TYPES[ctype][0]
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        return _samples(_scanlines(data, 0, h, w, bits, path)[0], w, depth, ctype)
    img, pos = None, 0
    for y0, x0, dy, dx in _ADAM7:
        ph, pw = (h - y0 + dy - 1) // dy, (w - x0 + dx - 1) // dx
        if ph <= 0 or pw <= 0:                      # an empty pass has no scanlines at all
            continue
        rows, pos = _scanlines(data, pos, ph, pw, bits, path)
        sub = _samples(rows, pw, depth, ctype)
        if img is None:                             # pass 1 holds pixel (0, 0)
            img = np.zeros((h, w) + sub.shape[2:], sub.dtype)
        img[y0::dy, x0::dx] = sub
    return img


def read_image(path: str) -> np.ndarray:
    """An image file as ``np.asarray(PIL.Image.open(path))``: through Pillow
    where it imports; without Pillow a PNG by ``decode_png``, and any other
    format (a JPEG of a Colmap scene, say) raises naming the file."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == _PNG_SIG:
        return png_array(blob, path)
    Image = _pillow_image()
    if Image is None:
        raise ValueError(f"{path}: not a PNG, and Pillow, which would read it, is not "
                         f"installed")
    with Image.open(path) as im:
        return np.asarray(im)


def save_image(path: str, img: np.ndarray):
    """float image in [0, 1] (clipped) → 8-bit PNG, as Pillow would write it."""
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
