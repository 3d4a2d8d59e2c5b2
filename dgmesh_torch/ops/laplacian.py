"""Uniform (umbrella) Laplacian regularizer on the padded mesh buffers, and
the per-face helpers (normals, centroids, areas) of the structural ops.

Counterpart of dgmesh_tpu/ops/laplacian.py::laplacian_uniform_tri
(reference nvdiffrast_utils/regularizer.py laplace_regularizer_const
:40-59): per vertex L(v) = (Σ neighbours)/deg − v over the face corners,
loss = Σ‖L‖² / (number of vertices with a face).  Invalid faces contribute
nothing; padded vertices get no gradient.
"""

from __future__ import annotations

import torch


def _laplacian_tri_fwd(tri, verts, faces, face_valid):
    V = verts.shape[0]
    keys = torch.where(face_valid[:, None], faces, V).reshape(-1)    # (3F,)
    contrib = tri.sum(dim=1, keepdim=True) - tri                     # Σ other corners
    c = contrib.reshape(-1, 3)
    c = torch.cat([c, torch.ones_like(c[:, :1])], -1)
    acc = tri.new_zeros((V + 1, 4)).index_add_(0, keys, c)[:V]
    nb, deg = acc[:, :3], 2.0 * acc[:, 3]                            # 2 neighbours per corner
    has = (deg > 0)[:, None]
    lap = nb / torch.clamp_min(deg, 1.0)[:, None] - torch.where(has, verts, 0.0)
    lap = torch.where(has, lap, 0.0)
    nv = torch.clamp_min(has.sum().to(verts.dtype), 1.0)
    return (lap * lap).sum() / nv, lap, deg, nv


class LaplacianUniformTri(torch.autograd.Function):
    """The loss over a pre-gathered corner tensor ``tri = verts[faces]``
    (shared with the mesh raster), with the analytic backward of
    ``_laplacian_tri_bwd`` (dgmesh_tpu/ops/laplacian.py:78-92): d tri is one
    (F,3) gather of lap/deg, d verts = −(2/nv)·lap."""

    @staticmethod
    def forward(ctx, tri, verts, faces, face_valid):
        loss, lap, deg, nv = _laplacian_tri_fwd(tri, verts, faces, face_valid)
        ctx.save_for_backward(faces, face_valid, lap, deg, nv)
        return loss

    @staticmethod
    def backward(ctx, g):
        faces, face_valid, lap, deg, nv = ctx.saved_tensors
        G = (lap / torch.clamp_min(deg, 1.0)[:, None])[faces]        # (F,3,3)
        dtri = G.sum(dim=1, keepdim=True) - G
        dtri = torch.where(face_valid[:, None, None], dtri, 0.0) * ((2.0 / nv) * g)
        dverts = lap * (-(2.0 / nv) * g)
        return dtri, dverts, None, None


def laplacian_uniform_tri(tri, verts, faces, face_valid):
    """Laplacian loss over ``tri = verts[faces]`` (F,3,3); verts (V,3),
    faces (F,3) int, face_valid (F,) bool."""
    return LaplacianUniformTri.apply(tri, verts, faces, face_valid)


# --- per-face helpers (dgmesh_tpu/ops/laplacian.py:95-113), zero on invalid faces

def face_normals(verts, faces, face_valid, normalize: bool = True):
    """(F,3) face normals (v1 − v0) × (v2 − v0), unit length with ``normalize``."""
    tri = verts[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    if normalize:
        n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
    return torch.where(face_valid[:, None], n, 0.0)


def face_centroids(verts, faces, face_valid):
    """(F,3) mean of each face's corners."""
    return torch.where(face_valid[:, None], verts[faces].mean(dim=1), 0.0)


def face_areas(verts, faces, face_valid):
    """(F,) triangle areas."""
    tri = verts[faces]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    return torch.where(face_valid, 0.5 * torch.linalg.norm(n, dim=-1), 0.0)
