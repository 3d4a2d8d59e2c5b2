"""The work the inputs need, and the chip's peaks: the yardstick of every
roofline and ``mfu`` share.

Counts are taken from shapes and sizes the inputs need (live Gaussians,
valid mesh vertices, valid tile rows), never from what one implementation
happens to execute: a net that runs on every padded slot is counted on the
live ones, a kernel that reads a row twice is counted once.  Where the
needed operations depend on the data in a way the sizes do not show (the
splat's early stop at saturation, the mesh backward's non-zero pairs), only
the bytes are counted, so the share stays a lower bound.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_F32 = 67e12          # float32 outside the tensor cores
PEAK_BF16 = 989e12        # bf16 tensor cores, float32 sums
PEAK_BYTES = 3.35e12      # HBM3

WIDTH, DEPTH = 256, 8
POS_LANES = 63            # xyz, sin and cos at 10 frequencies
TIME_LANES = {True: 30, False: 21}   # blender timenet output; else 2·10 + 1
TIMENET_MACS = 13 * 256 + 256 * 30   # blender timenet: 13 → 256 → 30
HEADS = {"deform": 13, "deform_normal": 3, "deform_back": 13, "deform_back_normal": 3,
         "appearance": 3}

# values a tile row needs: mean, conic, opacity, rgb; the screen triangle,
# its clip 1/w, the corner colours and the face id (the layouts' flag and
# padding lanes are not needed)
SPLAT_LANES = 9
RASTER_LANES = 19
# the least float32 operations one (pixel, valid face row) pair of the mesh
# raster needs: three edge functions (2 multiply-adds each, 4 operations),
# three inside tests, the depth (2 multiply-adds) and its compare
RASTER_PAIR_OPS = 3 * 4 + 3 + 4 + 1


def trunk_macs(din: int) -> int:
    """Multiply-adds of the 8×256 trunk for one row: din → 256, six 256 →
    256 layers, and the skip layer's din + 256 → 256."""
    return WIDTH * (2 * din + 7 * WIDTH)


def net_flops(rows: float, blender: bool, net: str, backward: bool, input_grad: bool):
    """(trunk flops, other flops) of one net applied to ``rows`` rows: the
    trunk, and the timenet and heads.  The backward needs every weight's
    gradient and every hidden input's, and the first layer's input gradient
    only where the net's input takes one."""
    din = POS_LANES + TIME_LANES[blender]
    trunk = 2.0 * trunk_macs(din)
    other = 2.0 * (WIDTH * HEADS[net] + (TIMENET_MACS if blender else 0))
    if backward:
        trunk *= 3.0
        other *= 3.0
        if not input_grad:
            trunk -= 2.0 * WIDTH * din
    return rows * trunk, rows * other


def fft_flops(res: int) -> float:
    """One real 3-D FFT of res³ points: half of a complex one's 5 N log2 N."""
    n = float(res) ** 3
    return 2.5 * n * math.log2(n)


def splat_bytes(valid_rows: float, pixels: float, backward: bool) -> float:
    """Kernel 1: each valid tile row read once, rgb and alpha written per
    pixel.  Kernel 2: the rows read and their gradients written, the pixel
    cotangents read."""
    if backward:
        return 2.0 * valid_rows * SPLAT_LANES * 4 + pixels * 4 * 4
    return valid_rows * SPLAT_LANES * 4 + pixels * 4 * 4


def raster_bytes(valid_rows: float, pixels: float, backward: bool, soft: bool) -> float:
    """Kernel 3: each valid tile row read once, rgb and the coverage written
    per pixel, and the soft silhouette where training asks for it.  Kernel
    4: rows read, gradients written, cotangents read."""
    if backward:
        return 2.0 * valid_rows * RASTER_LANES * 4 + pixels * 4 * 4
    return valid_rows * RASTER_LANES * 4 + pixels * (5 if soft else 4) * 4


def raster_ops(pairs: float) -> float:
    return pairs * RASTER_PAIR_OPS


def least_seconds(flops_at_peak, bytes_: float = 0.0) -> float:
    """The least time of work given as [(flops, peak)] and bytes: the larger
    of the arithmetic's time and the bytes' time."""
    return max(sum(f / p for f, p in flops_at_peak), bytes_ / PEAK_BYTES)
