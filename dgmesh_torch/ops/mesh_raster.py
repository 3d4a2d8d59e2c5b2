"""Triangle mesh rasterization: project, bin, shade; differentiable.

Counterpart of dgmesh_tpu/ops/mesh_raster.py with ``use_pallas=True`` (every
shipped config; replacing nvdiffrast in the reference, utils/renderer.py:33-121):
faces are projected (``_face_screen``), binned per tile with a 1 px bbox pad
and an optional backface cull (``rasterize``), and shaded per tile in the
CUDA kernels (ops/mesh_raster_kernels.py: kernel 3 forward, kernel 4 its
analytic backward through rgb and the soft silhouette, paired in
``ShadeTiles``): z-buffer, perspective-correct colour, hard coverage, winner
face id and the SoftRas soft silhouette.  Gradients reach the vertices and
their colours through autograd of the projection and the tile-row gathers.

Camera convention: an OpenGL modelview ``pose`` (w2c, camera looking down
−z) and projection; pixel y grows downward; pixel centres are +0.5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from .binning import bin_rects, quantize_depth, rect_from_bbox
from .mesh_raster_kernels import AREA_MIN, ShadeTiles
from .splat import untile


class MeshRasterConfig(NamedTuple):
    width: int
    height: int
    tile_h: int = 16
    tile_w: int = 16
    max_per_tile: int = 256
    max_dup: int = 1 << 21
    sigma: float = 1.0        # soft-silhouette bandwidth in pixels
    eps_w: float = 1e-4       # near-plane guard
    # drop back-facing triangles before binning (valid for closed meshes with
    # consistent outward winding, which marching_tets produces)
    cull_backface: bool = False

    @property
    def tiles_x(self):
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self):
        return -(-self.height // self.tile_h)

    @property
    def num_tiles(self):
        return self.tiles_x * self.tiles_y


def _to_screen(clip: torch.Tensor, cfg: MeshRasterConfig):
    """GL clip coordinates (...,4) → screen xy (...,2), w, ok, safe w."""
    w = clip[..., 3]
    ok = w > cfg.eps_w
    w_safe = torch.where(ok, w, 1.0)
    ndc = clip[..., :3] / w_safe[..., None]
    px = (ndc[..., 0] * 0.5 + 0.5) * cfg.width
    py = (0.5 - ndc[..., 1] * 0.5) * cfg.height    # y down (image convention)
    return torch.stack([px, py], -1), w, ok, w_safe


def project_verts(verts, pose, proj, cfg: MeshRasterConfig):
    """world verts (V,3) → screen xy (V,2), clip w (V,), ok mask."""
    hom = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    scr, w, ok, _ = _to_screen((hom @ pose.T) @ proj.T, cfg)
    return scr, w, ok


def _face_screen(verts, faces, face_valid, pose, proj, cfg: MeshRasterConfig,
                 tri_w=None):
    """Per-face screen triangles (F,3,2), inv_w (F,3), valid (F,).

    Projects the gathered corners with ``proj @ pose`` in that association,
    as the JAX version does.  ``tri_w`` is the optional pre-gathered
    ``verts[faces]``, shared with the Laplacian in the training step."""
    if tri_w is None:
        tri_w = verts[faces]                           # (F,3,3)
    hom = torch.cat([tri_w, torch.ones_like(tri_w[..., :1])], dim=-1)
    tri, _, ok, w_safe = _to_screen(hom @ (proj @ pose).T, cfg)
    return tri, 1.0 / w_safe, face_valid & ok.all(dim=1)


@tracing.span("raster.rasterize")
def rasterize(verts, faces, face_valid, pose, proj, cfg: MeshRasterConfig,
              tri_w=None):
    """Bin the faces per tile.  Returns the bins and the packed per-face
    shading rows (F,9): screen triangle | inv_w."""
    tri, inv_w, fvalid = _face_screen(verts, faces, face_valid, pose, proj, cfg, tri_w)
    if cfg.cull_backface:
        # screen-space signed area (y down): front faces of a closed,
        # outward-wound mesh are negative
        e1 = tri[:, 1] - tri[:, 0]
        e2 = tri[:, 2] - tri[:, 0]
        fvalid = fvalid & (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0] < 0.0)
    pad = 1.0  # 1 px guard so the soft silhouette's support is not clipped
    x0 = torch.floor(tri[..., 0].amin(1) - pad)
    x1 = torch.ceil(tri[..., 0].amax(1) + pad)
    y0 = torch.floor(tri[..., 1].amin(1) - pad)
    y1 = torch.ceil(tri[..., 1].amax(1) + pad)
    tx0, ty0, nx, ny = rect_from_bbox(x0, y0, x1, y1, tile_w=cfg.tile_w,
                                      tile_h=cfg.tile_h, tiles_x=cfg.tiles_x,
                                      tiles_y=cfg.tiles_y)
    depth = 1.0 / torch.clamp_min(inv_w.mean(dim=1), 1e-6)
    bins = bin_rects(tx0, ty0, nx, ny, quantize_depth(depth, fvalid), fvalid,
                     tiles_x=cfg.tiles_x, tiles_y=cfg.tiles_y,
                     max_dup=cfg.max_dup, max_per_tile=cfg.max_per_tile)
    pack = torch.cat([tri.reshape(-1, 6), inv_w], dim=-1)
    return dict(bins=bins, tri=tri, inv_w=inv_w, pack=pack, fvalid=fvalid)


def tile_attrs(rast, faces, vtx_color):
    """The kernel's (T,K,24) input: screen triangle and inv_w, the valid flag,
    the 9 corner colours, the face id (0 in empty slots), zero padding to 24
    lanes.  Only the valid slots are gathered, so the gathers' backward
    scatters each face's and vertex's gradient once per tile that holds it
    (see splat.tile_attrs)."""
    tidx = rast["bins"].tile_idx
    T, K = tidx.shape
    flat = tidx.reshape(-1)
    slots = torch.nonzero(flat >= 0).squeeze(1)
    fi = flat[slots]
    attrs = rast["pack"].new_zeros((T * K, 24))
    attrs[slots, 0:9] = rast["pack"][fi]
    attrs[:, 9] = (flat >= 0).float()
    attrs[slots, 10:19] = vtx_color[faces[fi]].reshape(-1, 9)
    attrs[:, 19] = flat.clamp_min(0).float()
    return attrs.reshape(T, K, 24)


def _untile(x, cfg: MeshRasterConfig):
    return untile(x, cfg.tiles_x, cfg.tiles_y, cfg.tile_h, cfg.tile_w,
                  cfg.height, cfg.width)


def render_mesh(verts, faces, face_valid, vtx_color, pose, proj, bg_color,
                cfg: MeshRasterConfig, want_soft: bool = True, tri_w=None):
    """Full mesh render (reference utils/renderer.py render_mask :33-66 +
    render_mesh :69-121).  Returns rgb (H,W,3), mask (H,W) hard coverage,
    face_id (H,W) (-1 = background), aux (binning counters), and with
    ``want_soft`` the soft silhouette ``soft_mask`` and ``st_mask`` (the
    hard value with the soft gradient).  ``tri_w``: optional pre-gathered
    ``verts[faces]``."""
    rast = rasterize(verts, faces, face_valid, pose, proj, cfg, tri_w)
    bins = rast["bins"]
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=verts.device)
    with tracing.span("raster.shade"):
        attrs = tile_attrs(rast, faces, vtx_color)
        rgb, hard, soft, fid = ShadeTiles.apply(attrs, cfg.tiles_x, cfg.tile_h,
                                                cfg.tile_w, cfg.sigma)
    rgb = rgb + (1.0 - hard)[..., None] * bg[None, None, :]
    fid_out = torch.where(hard > 0.5, fid.long(), -1)
    out = dict(rgb=_untile(rgb, cfg), mask=_untile(hard, cfg),
               face_id=_untile(fid_out, cfg),
               aux=dict(num_duplicates=bins.num_duplicates,
                        dup_overflow=bins.dup_overflow,
                        tile_overflow=bins.tile_overflow))
    if want_soft:
        soft = _untile(soft, cfg)
        out["soft_mask"] = soft
        # straight-through mask: the hard value with the soft gradient
        out["st_mask"] = out["mask"].detach() + (soft - soft.detach())
    return out


@torch.no_grad()
def render_mesh_shape(verts, faces, face_valid, pose, proj, cam_center,
                      cfg: MeshRasterConfig, bg_color=None, light_dir=None,
                      ambient=0.5, diffuse=0.3, specular=0.2, shininess=10.0):
    """Per-pixel Blinn-Phong shape render: a white mesh on a white background
    (dgmesh_tpu/ops/mesh_raster.py::render_mesh_shape; the reference's
    pytorch3d shape pass, utils/renderer.py mesh_shape_renderer :236-319:
    a directional light from the camera at the mesh centre, specular 0.2,
    shininess 10, pytorch3d's ambient 0.5 and diffuse 0.3).

    Rasterizes once through ``render_mesh`` with white vertex colours
    (kernel 3) for the winning face per pixel, then shades each pixel:
    perspective-correct barycentrics of the winner's projected corners →
    the interpolated vertex normal and world position → Blinn-Phong.  The
    light aims at the mean of the valid faces' first corners (not of all
    three, as ``phong_vertex_colors``'s does, in JAX too).  Returns rgb
    (H,W,3), mask (H,W), face_id (H,W), normal and position (H,W,3), zero
    where no face covers the pixel."""
    faces = faces.long()
    dev = verts.device
    bg = (torch.ones(3, device=dev) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))
    out = render_mesh(verts, faces, face_valid, torch.ones_like(verts), pose, proj, bg, cfg,
                      want_soft=False)
    fid = out["face_id"]                                    # (H,W)
    covered = (fid >= 0)[..., None]
    f = faces[fid.clamp_min(0)]                             # (H,W,3)

    # project all verts once; per-pixel gather of the 3 winning corners
    scr, w, _ = project_verts(verts, pose, proj, cfg)
    inv_w = (1.0 / torch.clamp_min(w, cfg.eps_w))[f]        # (H,W,3)
    tri = scr[f]                                            # (H,W,3,2)
    H, W = fid.shape
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    (ax, bx, cx), (ay, by, cy) = tri[..., 0].unbind(-1), tri[..., 1].unbind(-1)
    e0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
    e1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
    e2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    area = torch.where(area.abs() < AREA_MIN, 1.0, area)  # the shade kernels' guard
    pw = torch.stack([e0, e1, e2], dim=-1) / area[..., None] * inv_w   # perspective-correct
    pw = pw / torch.clamp_min(pw.sum(-1, keepdim=True), 1e-12)

    vn = vertex_normals(verts, faces, face_valid)
    n = (pw[..., None] * vn[f]).sum(-2)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-9)
    p = (pw[..., None] * verts[f]).sum(-2)                  # world position

    cam = torch.as_tensor(cam_center, dtype=torch.float32, device=dev)
    if light_dir is None:
        v0 = torch.where(face_valid[:, None], verts[faces[:, 0]], 0.0)
        light_dir = v0.sum(0) / face_valid.sum().float().clamp_min(1.0) - cam
    light = -torch.as_tensor(light_dir, dtype=torch.float32, device=dev)
    light = light / (torch.linalg.vector_norm(light) + 1e-9)
    view = cam - p
    view = view / (torch.linalg.vector_norm(view, dim=-1, keepdim=True) + 1e-9)
    ndl = (n * light).sum(-1, keepdim=True).abs()
    h = light + view
    h = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-9)
    ndh = (n * h).sum(-1, keepdim=True).abs()
    shade = torch.clamp(ambient + diffuse * ndl + specular * ndh ** shininess, 0.0, 1.0)
    rgb = torch.where(covered, shade.expand(H, W, 3), bg)
    return dict(rgb=rgb, mask=covered[..., 0].float(), face_id=fid,
                normal=torch.where(covered, n, 0.0), position=torch.where(covered, p, 0.0))


def phong_vertex_colors(verts, faces, face_valid, cam_center, light_dir=None,
                        ambient=0.5, diffuse=0.3, specular=0.2, shininess=10.0):
    """Blinn-Phong vertex shading for the shape render
    (dgmesh_tpu/ops/mesh_raster.py::phong_vertex_colors; the reference's
    pytorch3d SoftPhongShader setup, utils/renderer.py:236-319: white
    vertices, a directional light from the camera towards the mesh centre,
    specular 0.2, shininess 10, ambient 0.5, diffuse 0.3), per vertex
    (Gouraud) with area-weighted vertex normals.  Returns (V,3)."""
    faces = faces.long()
    vn = vertex_normals(verts, faces, face_valid)
    cam = torch.as_tensor(cam_center, dtype=torch.float32, device=verts.device)
    if light_dir is None:
        v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        corners = torch.where(face_valid[:, None], v0 + v1 + v2, 0.0)
        wsum = torch.clamp_min(face_valid.sum() * 3.0, 1.0)
        light_dir = corners.sum(0) / wsum - cam
    light = -torch.as_tensor(light_dir, dtype=torch.float32, device=verts.device)
    light = light / (torch.linalg.norm(light) + 1e-9)
    view = cam - verts
    view = view / (torch.linalg.norm(view, dim=-1, keepdim=True) + 1e-9)
    ndl = (vn * light[None, :]).sum(-1, keepdim=True).abs()
    h = light[None, :] + view
    h = h / (torch.linalg.norm(h, dim=-1, keepdim=True) + 1e-9)
    ndh = (vn * h).sum(-1, keepdim=True).abs()
    shade = ambient + diffuse * ndl + specular * ndh ** shininess
    return torch.clamp(shade, 0.0, 1.0) * torch.ones((1, 3), device=verts.device)


def vertex_normals(verts, faces, face_valid):
    """Area-weighted vertex normals (pytorch3d ``verts_normals`` convention)."""
    faces = faces.long()
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.where(face_valid[:, None], torch.linalg.cross(v1 - v0, v2 - v0), 0.0)
    vn = torch.zeros_like(verts).index_add_(0, faces.reshape(-1), fn.repeat_interleave(3, 0))
    return vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-9)
