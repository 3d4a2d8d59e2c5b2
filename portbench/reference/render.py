"""The two renderers in plain PyTorch: the Gaussian splat and the mesh raster.

Both follow the JAX package's ``ops/splat.py``, ``ops/mesh_raster.py`` and
``ops/binning.py`` (upstream: the 3DGS rasterizer's ``forward.cu`` and
``auxiliary.h``, and nvdiffrast in DG-Mesh's ``utils/renderer.py``):
project, bin into 16×16 tiles, composite or shade each tile.  The tile
lists are those semantics exactly: an item's tiles row-major over its
rectangle, items in id order, the first ``max_dup`` pairs kept, each tile's
items ordered by a 14-bit quantized depth with ties to the lower id, the
nearest ``max_per_tile`` kept.  The per-tile work is the plain twins of
the program's kernels 1–4 (``composite.py``, ``shade.py``).

Cameras are built here from the raw view (a Blender camera-to-world pose
and the pinhole intrinsics): the 3DGS world-to-view and projection
matrices (``getWorld2View2``, ``getProjectionMatrix`` or, with
intrinsics, ``getProjectionMatrix_from_K``, z-near 0.01, z-far 100) and
nvdiffrast's OpenGL pose and projection (z-near 0.1, z-far 1000).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .composite import CompositeTiles
from .shade import ShadeTiles

TILE = 16
NEAR_CULL = 0.2
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Cam(NamedTuple):
    width: int
    height: int
    world_view: torch.Tensor   # (4,4) world → camera (OpenCV axes)
    full_proj: torch.Tensor    # (4,4) projection @ world_view
    campos: torch.Tensor       # (3,)
    tanfovx: float
    tanfovy: float
    gl_pose: torch.Tensor      # (4,4) world → camera (OpenGL axes)
    gl_proj: torch.Tensor      # (4,4)


def make_cam(view, use_K: bool, device) -> Cam:
    """A view's matrices.  ``use_K``: the projection from the intrinsics
    (the Nerfies reader's), else from the fields of view (Blender's, whose
    principal point is the centre)."""
    W, H = view.width, view.height
    K = np.asarray(view.K, np.float64)
    fx = float(K[0, 0])
    fovx = 2.0 * math.atan(W / (2.0 * fx))
    fy = float(K[1, 1]) if use_K else W / (2.0 * math.tan(fovx / 2.0))
    fovy = 2.0 * math.atan(H / (2.0 * fy))
    cx, cy = (float(K[0, 2]), float(K[1, 2])) if use_K else (W / 2.0, H / 2.0)
    c2w = np.asarray(view.c2w, np.float64)
    c2w_cv = c2w @ np.diag([1.0, -1.0, -1.0, 1.0])
    w2c = np.linalg.inv(c2w_cv).astype(np.float32)
    zn, zf = 0.01, 100.0
    P = np.zeros((4, 4), np.float32)
    if use_K:
        top, bottom = zn * cy / fy, -zn * (H - cy) / fy
        right, left = zn * (W - cx) / fx, -zn * cx / fx
        P[0, 0] = 2 * zn / (right - left)
        P[1, 1] = 2 * zn / (top - bottom)
        P[0, 2] = -(right + left) / (right - left)
        P[1, 2] = (top + bottom) / (top - bottom)
    else:
        P[0, 0] = 1.0 / math.tan(fovx / 2)
        P[1, 1] = 1.0 / math.tan(fovy / 2)
    P[3, 2] = 1.0
    P[2, 2] = zf / (zf - zn)
    P[2, 3] = -(zf * zn) / (zf - zn)
    n, f = 0.1, 1000.0
    G = np.zeros((4, 4), np.float32)
    G[0, 0], G[0, 2] = 2 * fx / W, 1.0 - 2.0 * cx / W
    G[1, 1], G[1, 2] = 2 * fy / H, 2.0 * cy / H - 1.0
    G[2, 2], G[2, 3], G[3, 2] = -(f + n) / (f - n), -2.0 * f * n / (f - n), -1.0
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return Cam(W, H, t(w2c), t(P @ w2c), t(np.linalg.inv(w2c.astype(np.float64))[:3, 3]),
               math.tan(fovx / 2), math.tan(fovy / 2),
               t(np.linalg.inv(c2w.astype(np.float32))), t(G))


# --- tile binning ----------------------------------------------------------

def depth_keys(depth: torch.Tensor, valid: torch.Tensor, depth_bits: int) -> torch.Tensor:
    """Each item's depth bucket: its depth over the valid items' range as a
    30-bit integer, of which the top ``depth_bits`` bits."""
    lo = torch.where(valid, depth, math.inf).min()
    hi = torch.where(valid, depth, -math.inf).max()
    q = (depth - lo) / torch.clamp_min(hi - lo, 1e-6) * float(1 << 30)
    q = torch.where(valid & torch.isfinite(q), q, 0.0).to(torch.int32).long()
    return ((q >> 16).clamp(0, (1 << 14) - 1) >> (14 - depth_bits)).clamp(0, (1 << depth_bits) - 1)


def tile_lists(tx0, ty0, nx, ny, depth, valid, tiles_x: int, tiles_y: int, max_dup: int,
               K: int):
    """(tiles, K) item ids, nearest first, -1 padded; and the entries past K."""
    dev = tx0.device
    n_tiles = tiles_x * tiles_y
    bits = min(31 - max(int(n_tiles + 1).bit_length(), 1), 14)
    cnt = torch.where(valid, nx * ny, 0).long()
    item = torch.repeat_interleave(torch.arange(cnt.numel(), device=dev), cnt)[:max_dup]
    first = torch.cumsum(cnt, 0) - cnt
    k = torch.arange(item.numel(), device=dev) - first[item]
    w = nx[item].long()
    tile = (ty0[item].long() + k // w) * tiles_x + tx0[item].long() + k % w
    key = tile * (1 << bits) + depth_keys(depth, valid, bits)[item]
    order = torch.sort(key, stable=True).indices
    tile, item = tile[order], item[order]
    per_tile = torch.bincount(tile, minlength=n_tiles)
    rank = torch.arange(tile.numel(), device=dev) - (torch.cumsum(per_tile, 0) - per_tile)[tile]
    keep = rank < K
    out = torch.full((n_tiles, K), -1, dtype=torch.long, device=dev)
    out[tile[keep], rank[keep]] = item[keep]
    return out, (per_tile - K).clamp_min(0).sum()


def untile(x: torch.Tensor, tiles_x: int, tiles_y: int, height: int, width: int):
    """(tiles, 256, …) → (H, W, …)."""
    rest = x.shape[2:]
    x = x.reshape(tiles_y, tiles_x, TILE, TILE, *rest).transpose(1, 2)
    return x.reshape(tiles_y * TILE, tiles_x * TILE, *rest)[:height, :width]


def gather_rows(ids: torch.Tensor, rows: torch.Tensor, lanes: int) -> torch.Tensor:
    """(tiles, K, lanes) of each listed item's row, the listed flag at lane
    ``rows.shape[1]``, zeros elsewhere."""
    T, K = ids.shape
    flat = ids.reshape(-1)
    slot = torch.nonzero(flat >= 0).squeeze(1)
    out = rows.new_zeros((T * K, lanes))
    out[slot, :rows.shape[1]] = rows[flat[slot]]
    out[:, rows.shape[1]] = (flat >= 0).float()
    return out.reshape(T, K, lanes)


# --- Gaussian splat --------------------------------------------------------

def sh_colour(deg: int, sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Upstream's real SH (degree ≤ 3) of coefficients sh (N,16,3) in unit
    directions d (N,3), plus 0.5."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = SH_C0 * sh[:, 0]
    if deg > 0:
        c = c - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = (c + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2 * zz - xx - yy) * sh[:, 6] + SH_C2[3] * xz * sh[:, 7]
             + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        c = (c + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9] + SH_C3[1] * xy * z * sh[:, 10]
             + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
             + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14] + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return c + 0.5


def quat_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (N,3,3) of quaternions (w,x,y,z), normalised."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def splat(means, scales, quats, opacity, shs, alive, cam: Cam, bg, sh_deg: int,
          max_per_tile: int, max_dup: int):
    """The splat image (3,H,W) and its entries past the tile cap."""
    W, H = cam.width, cam.height
    hom = torch.cat([means, torch.ones_like(means[:, :1])], -1)
    pv = hom @ cam.world_view.T
    depth = pv[:, 2]
    ph = hom @ cam.full_proj.T
    pw = 1.0 / (ph[:, 3] + 1e-7)
    mx = ((ph[:, 0] * pw + 1.0) * W - 1.0) * 0.5
    my = ((ph[:, 1] * pw + 1.0) * H - 1.0) * 0.5
    # EWA: Σ' = J W Σ Wᵀ Jᵀ + 0.3 I, the view-space point clamped to 1.3 × the frustum
    Rm = quat_matrix(quats) * scales[:, None, :]
    cov3 = Rm @ Rm.transpose(1, 2)
    tz = torch.where(depth.abs() < 1e-6, 1e-6, depth)
    fx, fy = W / (2.0 * cam.tanfovx), H / (2.0 * cam.tanfovy)
    lx, ly = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    tx = torch.clamp(pv[:, 0] / tz, -lx, lx) * tz
    ty = torch.clamp(pv[:, 1] / tz, -ly, ly) * tz
    z0 = torch.zeros_like(tz)
    J = torch.stack([torch.stack([fx / tz, z0, -fx * tx / (tz * tz)], -1),
                     torch.stack([z0, fy / tz, -fy * ty / (tz * tz)], -1)], -2)
    Tm = J @ cam.world_view[:3, :3]
    cov2 = Tm @ cov3 @ Tm.transpose(1, 2)
    a, b, c = cov2[:, 0, 0] + 0.3, cov2[:, 0, 1], cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    inv = torch.where(det > 0, det, 1.0)
    conic = torch.stack([c / inv, -b / inv, a / inv], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(
        mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1)), 0.0)))
    d = means - cam.campos
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-12)
    rgb = sh_colour(sh_deg, shs, d)
    rgb = torch.maximum(rgb, torch.zeros_like(rgb))
    valid = alive & (depth > NEAR_CULL) & (det > 0) & (radius > 0)
    radius = torch.where(valid, radius, 0.0)
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    tx0 = torch.clamp((mx - radius) / TILE, 0, tiles_x).int()
    ty0 = torch.clamp((my - radius) / TILE, 0, tiles_y).int()
    tx1 = torch.clamp(torch.floor((mx + radius + TILE - 1) / TILE), 0, tiles_x).int()
    ty1 = torch.clamp(torch.floor((my + radius + TILE - 1) / TILE), 0, tiles_y).int()
    ids, over = tile_lists(tx0, ty0, (tx1 - tx0).clamp_min(0), (ty1 - ty0).clamp_min(0),
                           depth, valid, tiles_x, tiles_y, max_dup, max_per_tile)
    rows = torch.cat([torch.stack([mx, my], -1), conic, opacity.reshape(-1, 1), rgb], -1)
    out, alpha = CompositeTiles.apply(gather_rows(ids, rows, 16), tiles_x, TILE, TILE)
    img = out + (1.0 - alpha)[..., None] * bg
    return untile(img, tiles_x, tiles_y, H, W).permute(2, 0, 1), over


# --- mesh raster -------------------------------------------------------------

def raster(verts, faces, face_valid, colours, cam: Cam, bg, sigma: float, max_per_tile: int,
           max_dup: int):
    """The mesh image (H,W,3), its hard coverage (H,W) with the soft
    silhouette's gradient, and the entries past the tile cap."""
    W, H = cam.width, cam.height
    idx = torch.nonzero(face_valid).squeeze(1)
    tri = verts.new_zeros(faces.shape + (3,))
    tri[idx] = verts[faces[idx]]
    clip = torch.cat([tri, torch.ones_like(tri[..., :1])], -1) @ (cam.gl_proj @ cam.gl_pose).T
    w = clip[..., 3]
    ok = w > 1e-4
    w = torch.where(ok, w, 1.0)
    sx = (clip[..., 0] / w * 0.5 + 0.5) * W
    sy = (0.5 - clip[..., 1] / w * 0.5) * H
    inv_w = 1.0 / w
    fvalid = face_valid & ok.all(1)
    tiles_x, tiles_y = -(-W // TILE), -(-H // TILE)
    x0, x1 = torch.floor(sx.amin(1) - 1.0), torch.ceil(sx.amax(1) + 1.0)
    y0, y1 = torch.floor(sy.amin(1) - 1.0), torch.ceil(sy.amax(1) + 1.0)
    tx0 = torch.clamp(x0 / TILE, 0, tiles_x).int()
    ty0 = torch.clamp(y0 / TILE, 0, tiles_y).int()
    tx1 = torch.clamp(torch.floor((x1 + TILE - 1) / TILE), 0, tiles_x).int()
    ty1 = torch.clamp(torch.floor((y1 + TILE - 1) / TILE), 0, tiles_y).int()
    depth = 1.0 / torch.clamp_min(inv_w.mean(1), 1e-6)
    ids, over = tile_lists(tx0, ty0, (tx1 - tx0).clamp_min(0), (ty1 - ty0).clamp_min(0),
                           depth, fvalid, tiles_x, tiles_y, max_dup, max_per_tile)
    rows = torch.cat([torch.stack([sx, sy], -1).reshape(-1, 6), inv_w], -1)
    attrs = gather_rows(ids, rows, 24)
    flat = ids.reshape(-1)
    slot = torch.nonzero(flat >= 0).squeeze(1)
    extra = attrs.new_zeros((flat.numel(), 24))
    extra[slot, 10:19] = colours[faces[flat[slot]]].reshape(-1, 9)
    extra[:, 19] = flat.clamp_min(0).float()
    attrs = attrs + extra.reshape(attrs.shape)
    rgb, hard, soft, _ = ShadeTiles.apply(attrs, tiles_x, TILE, TILE, sigma)
    rgb = rgb + (1.0 - hard)[..., None] * bg
    hard = untile(hard, tiles_x, tiles_y, H, W)
    soft = untile(soft, tiles_x, tiles_y, H, W)
    return untile(rgb, tiles_x, tiles_y, H, W), hard.detach() + (soft - soft.detach()), over
