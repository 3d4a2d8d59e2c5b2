"""3D Gaussian splatting: project, bin, composite; differentiable.

Counterpart of dgmesh_tpu/ops/splat.py with ``use_pallas=True`` (every shipped
config): preprocess (EWA projection) → tile binning (ops/binning.py) →
per-tile compositing in the CUDA kernels (ops/splat_kernels.py: kernel 1
forward, kernel 2 its analytic backward, paired in ``CompositeTiles``), then
the background blend and the untile.  Gradients reach the Gaussians through
autograd of the preprocess and of the tile-row gather; the binning carries
none (integer tile lists), as in JAX where it is stop-gradient.

Splat pixel centres are integer (the kernel's px = tile origin + lane);
the mesh rasterizer's are +0.5.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import sh as sh_ops
from .binning import bin_rects, quantize_depth
from .splat_kernels import CompositeTiles

NEAR_CULL = 0.2  # reference: auxiliary.h in_frustum :139


class SplatConfig(NamedTuple):
    width: int
    height: int
    tile_h: int = 16
    tile_w: int = 16
    max_per_tile: int = 1024
    max_dup: int = 1 << 22

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self) -> int:
        return self.tiles_x * self.tiles_y


class CameraArrays(NamedTuple):
    """Device-side camera tensors."""
    world_view: torch.Tensor   # (4,4) world→camera
    full_proj: torch.Tensor    # (4,4) projection @ world_view
    campos: torch.Tensor       # (3,)
    tanfovx: torch.Tensor      # ()
    tanfovy: torch.Tensor      # ()

    @staticmethod
    def from_camera(cam, device) -> "CameraArrays":
        f32 = dict(dtype=torch.float32, device=device)
        return CameraArrays(
            world_view=torch.as_tensor(cam.world_view, **f32),
            full_proj=torch.as_tensor(cam.full_proj, **f32),
            campos=torch.as_tensor(cam.camera_center, **f32),
            tanfovx=torch.tensor(math.tan(cam.fovx * 0.5), **f32),
            tanfovy=torch.tensor(math.tan(cam.fovy * 0.5), **f32),
        )


def preprocess(means3d, scales, quats, opacities, shs, alive, cam: CameraArrays,
               cfg: SplatConfig, sh_degree: int):
    """Project Gaussians to screen space (reference forward.cu:156-256).

    ``valid`` folds in the alive mask, the near cull, and the
    degenerate-covariance cull."""
    from .quaternion import build_covariance

    W, H = cfg.width, cfg.height
    fx = W / (2.0 * cam.tanfovx)
    fy = H / (2.0 * cam.tanfovy)

    hom = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)   # (N,4)
    p_view = hom @ cam.world_view.T
    depth = p_view[:, 2]
    in_front = depth > NEAR_CULL

    p_hom = hom @ cam.full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    px = ((p_proj[:, 0] + 1.0) * W - 1.0) * 0.5       # ndc2Pix, auxiliary.h:41
    py = ((p_proj[:, 1] + 1.0) * H - 1.0) * 0.5
    mean2d = torch.stack([px, py], dim=-1)

    cov3d = build_covariance(scales, quats)            # (N,3,3)

    # EWA projection (reference forward.cu computeCov2D :74-113)
    tz = torch.where(depth.abs() < 1e-6, 1e-6, depth)
    limx = 1.3 * cam.tanfovx
    limy = 1.3 * cam.tanfovy
    txtz = torch.minimum(torch.maximum(p_view[:, 0] / tz, -limx), limx)
    tytz = torch.minimum(torch.maximum(p_view[:, 1] / tz, -limy), limy)
    tx = txtz * tz
    ty = tytz * tz
    zero = torch.zeros_like(tz)
    J = torch.stack([
        torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], dim=-1),
        torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], dim=-1),
    ], dim=-2)                                         # (N,2,3)
    T = J @ cam.world_view[:3, :3]
    cov2d = (T @ cov3d) @ T.transpose(-1, -2)
    cxx = cov2d[:, 0, 0] + 0.3
    cyy = cov2d[:, 1, 1] + 0.3
    cxy = cov2d[:, 0, 1]

    det = cxx * cyy - cxy * cxy
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, 1.0)
    conic = torch.stack([cyy / det_safe, -cxy / det_safe, cxx / det_safe], dim=-1)

    mid = 0.5 * (cxx + cyy)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

    dirs = means3d - cam.campos[None, :]
    dirs = dirs / (torch.linalg.norm(dirs, dim=-1, keepdim=True) + 1e-12)
    rgb = sh_ops.eval_sh(sh_degree, shs.transpose(-1, -2), dirs) + 0.5
    color = torch.maximum(rgb, rgb.new_zeros(()))     # ties split like jnp.maximum

    valid = alive & in_front & det_ok & (radius > 0)
    radius = torch.where(valid, radius, 0.0)
    return dict(mean2d=mean2d, depth=depth, conic=conic, color=color,
                opacity=opacities.reshape(-1), radius=radius, valid=valid)


def _tile_rects(mean2d, radius, valid, cfg: SplatConfig):
    """Per-Gaussian touched tile rectangle (reference auxiliary.h getRect :46)."""
    tw, th = cfg.tile_w, cfg.tile_h
    tx0 = ((mean2d[:, 0] - radius) / tw).clamp(0, cfg.tiles_x).to(torch.int32)
    ty0 = ((mean2d[:, 1] - radius) / th).clamp(0, cfg.tiles_y).to(torch.int32)
    tx1 = torch.div(mean2d[:, 0] + radius + tw - 1, tw, rounding_mode="floor") \
        .clamp(0, cfg.tiles_x).to(torch.int32)
    ty1 = torch.div(mean2d[:, 1] + radius + th - 1, th, rounding_mode="floor") \
        .clamp(0, cfg.tiles_y).to(torch.int32)
    nx = (tx1 - tx0).clamp_min(0)
    ny = (ty1 - ty0).clamp_min(0)
    return tx0, ty0, nx, ny


def bin_gaussians(pre: dict, cfg: SplatConfig):
    """Per-tile depth-sorted Gaussian ids (T,K), -1 padded, and the counters."""
    valid = pre["valid"]
    tx0, ty0, nx, ny = _tile_rects(pre["mean2d"], pre["radius"], valid, cfg)
    bins = bin_rects(tx0, ty0, nx, ny, quantize_depth(pre["depth"], valid), valid,
                     tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                     max_dup=cfg.max_dup, max_per_tile=cfg.max_per_tile)
    aux = dict(num_duplicates=bins.num_duplicates, dup_overflow=bins.dup_overflow,
               tile_overflow=bins.tile_overflow)
    return bins.tile_idx, aux


def _pack_attrs(pre):
    """Per-Gaussian compositing attributes (N,9): mean2d | conic | opacity | color."""
    return torch.cat([pre["mean2d"], pre["conic"], pre["opacity"][:, None],
                      pre["color"]], dim=-1)


def tile_attrs(tile_idx, pre):
    """The kernel's (T,K,16) input: packed rows of each tile's Gaussians in
    lanes 0-8, the valid flag in lane 9, zeros elsewhere and in the empty
    slots.  Only the valid slots are gathered: the gather's backward then
    scatters each Gaussian's gradient once per tile that holds it (gathering
    the empty slots as row 0, as JAX does, would pile every one of them on
    row 0 and serialise the scatter on the card)."""
    packed = _pack_attrs(pre)
    T, K = tile_idx.shape
    flat = tile_idx.reshape(-1)
    slots = torch.nonzero(flat >= 0).squeeze(1)
    attrs = packed.new_zeros((T * K, 16))
    attrs[slots, 0:9] = packed[flat[slots]]
    attrs[:, 9] = (flat >= 0).float()
    return attrs.reshape(T, K, 16)


def untile(x, tiles_x: int, tiles_y: int, tile_h: int, tile_w: int, height: int,
           width: int):
    """(T,P[,C]) tile-major → (H,W[,C]) image."""
    c = x.shape[2:]
    x = x.reshape(tiles_y, tiles_x, tile_h, tile_w, *c).transpose(1, 2)
    return x.reshape(tiles_y * tile_h, tiles_x * tile_w, *c)[:height, :width]


def composite(tile_idx, pre, bg, cfg: SplatConfig):
    """Composite all tiles through the kernels; returns image (H,W,3), alpha (H,W)."""
    attrs = tile_attrs(tile_idx, pre)
    rgb, alpha = CompositeTiles.apply(attrs, cfg.tiles_x, cfg.tile_h, cfg.tile_w)
    out = rgb + (1.0 - alpha)[..., None] * bg[None, None, :]
    geo = (cfg.tiles_x, cfg.tiles_y, cfg.tile_h, cfg.tile_w, cfg.height, cfg.width)
    return untile(out, *geo), untile(alpha, *geo)


def render(means3d, scales, quats, opacities, shs, alive, cam: CameraArrays,
           bg_color, cfg: SplatConfig, sh_degree: int, screen_offset=None):
    """Full splatting pass (reference gaussian_renderer/__init__.py:32-119).

    Returns render (3,H,W), alpha (H,W), radii (N,), visibility (N,), aux.
    ``screen_offset`` (N,2), if given, is added to the projected 2D means;
    pass zeros and take its gradient for the reference's viewspace_points
    densification statistic (gaussian_renderer/__init__.py:41-45)."""
    pre = preprocess(means3d, scales, quats, opacities, shs, alive, cam, cfg, sh_degree)
    if screen_offset is not None:
        pre = dict(pre, mean2d=pre["mean2d"] + screen_offset)
    tile_idx, aux = bin_gaussians(pre, cfg)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=means3d.device)
    img, alpha = composite(tile_idx, pre, bg, cfg)
    return dict(render=img.permute(2, 0, 1), alpha=alpha, radii=pre["radius"],
                visibility=pre["valid"], aux=aux)
