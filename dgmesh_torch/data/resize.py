"""Pillow's LANCZOS resize of 8-bit images, value for value, in numpy.

The reference resizes its frames with ``PIL.Image.resize(size, LANCZOS)``
(scene/dataset_readers.py:289, utils/camera_utils.py:23-63), and the JAX
package does the same (dgmesh_tpu/data/readers.py:53-60, scene.py:52-60).
The card's machine has no Pillow, so the port carries the resample itself,
as Pillow's libImaging/Resample.c computes it:

  - separable: a horizontal pass where the width changes, then a vertical
    pass where the height changes, with a uint8 image between the two;
  - output pixel x is centred at (x + 0.5) * scale in the input, scale =
    in / out; the filter is sinc(t) * sinc(t / 3) on |t| < 3, stretched by
    max(scale, 1), over the input pixels from int(centre - support + 0.5)
    to int(centre + support + 0.5) (clipped to the image), sampled at
    their centres;
  - each output pixel's weights are normalised to sum 1, then rounded to
    22-bit fixed point (half away from zero); the sum starts at 2^21 and is
    shifted right by 22 and clipped to [0, 255];
  - RGBA and LA are premultiplied by alpha before the passes and divided
    by it after (Pillow resizes them as RGBa and La), with Pillow's integer
    rounding both ways.

The sums are integers below 2^31, taken in int32 as Pillow's C ints, so
numpy reproduces them exactly; the weights are computed in float64 with
``math.sin`` (the C library's sin, as Pillow's).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
SUPPORT = 3.0


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v *= math.pi
        return math.sin(v) / v
    return sinc(x) * sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(first input index (out,), fixed-point weights (out, taps)) of one
    axis, Resample.c's precompute_coeffs and normalize_coeffs_8bpc; a
    weight past an output pixel's last input pixel is 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) / filterscale) for x in range(xmax)]
        ww = sum(w)   # a left-to-right double sum, as the C loop's
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            kk[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else \
                int(0.5 + k * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, kk


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of (H, W, C)."""
    first, kk = _coefficients(img.shape[axis], out_size)
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0)).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    n = src.shape[0]
    for j in range(kk.shape[1]):
        idx = np.minimum(first + j, n - 1)       # the weight is 0 past the last pixel
        acc += src[idx] * kk[:, j].astype(np.int32).reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(a: np.ndarray) -> np.ndarray:
    """Pillow's RGBA → RGBa (and LA → La): c·α/255 rounded, MULDIV255."""
    alpha = a[..., -1:].astype(np.int64)
    t = a[..., :-1].astype(np.int64) * alpha + 128
    return np.concatenate([((t >> 8) + t) >> 8, alpha], -1).astype(np.uint8)


def _unpremultiply(a: np.ndarray) -> np.ndarray:
    """Pillow's RGBa → RGBA (and La → LA): 255·c // α clipped to 255, the
    colour kept as it is where α is 0 or 255."""
    alpha = a[..., -1:].astype(np.int64)
    c = a[..., :-1].astype(np.int64)
    div = np.minimum(255 * c // np.maximum(alpha, 1), 255)
    keep = (alpha == 0) | (alpha == 255)
    return np.concatenate([np.where(keep, c, div), alpha], -1).astype(np.uint8)


def lanczos_resize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(img).resize(size, Image.LANCZOS))`` for
    a uint8 image (H,W) (L), (H,W,2) (LA), (H,W,3) (RGB) or (H,W,4) (RGBA);
    ``size`` is (width, height), as Pillow's."""
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim not in (2, 3) or (a.ndim == 3
                                                        and a.shape[2] not in (2, 3, 4)):
        raise ValueError(f"lanczos_resize takes uint8 L, LA, RGB or RGBA images, got "
                         f"{a.dtype} {a.shape}")
    nw, nh = int(size[0]), int(size[1])
    if nw < 1 or nh < 1:
        raise ValueError(f"lanczos_resize: size {size}")
    h, w = a.shape[:2]
    if (nw, nh) == (w, h):
        return a.copy()
    x = a[..., None] if a.ndim == 2 else a
    alpha = x.shape[2] in (2, 4)
    if alpha:
        x = _premultiply(x)
    if nw != w:
        x = _pass(x, nw, 1)
    if nh != h:
        x = _pass(x, nh, 0)
    if alpha:
        x = _unpremultiply(x)
    return x[..., 0] if a.ndim == 2 else x
