"""Canonical Gaussian point-set state in the padded layout.

Counterpart of dgmesh_tpu/models/gaussians.py (reference
scene/gaussian_model_dpsr_dynamic_anchor.py): fixed-capacity tensors plus an
``alive`` mask, the same leaves as the JAX ``GaussianParams`` /
``GaussianStats``, so a JAX state carries across leaf by leaf (convert.py).

  xyz (M,3) · f_dc (M,1,3) · f_rest (M,15,3) · scaling (M,3) log-scale ·
  rotation (M,4) wxyz · opacity (M,1) logit · normal (M,3) · density_thres ()
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class GaussianParams(NamedTuple):
    """Learnable leaves."""
    xyz: torch.Tensor
    f_dc: torch.Tensor
    f_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    normal: torch.Tensor
    density_thres: torch.Tensor


class GaussianStats(NamedTuple):
    """Non-learnable companions."""
    alive: torch.Tensor            # (M,) bool
    max_radii2d: torch.Tensor      # (M,)
    xyz_grad_accum: torch.Tensor   # (M,)
    denom: torch.Tensor            # (M,)
    gaussian_center: torch.Tensor  # (3,)
    gaussian_scale: torch.Tensor   # ()


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


# --- activations (reference: gaussian_model.py:73-81) -----------------------

def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    n = torch.linalg.norm(p.rotation, dim=-1, keepdim=True)
    return p.rotation / (n + 1e-12)


def get_features(p: GaussianParams) -> torch.Tensor:
    """(M, 16, 3) concatenated SH coefficients."""
    return torch.cat([p.f_dc, p.f_rest], dim=1)


def create_from_pcd(points: np.ndarray, colors: np.ndarray, capacity: int,
                    sh_degree: int = 3, init_density_threshold: float = 0.0,
                    device: DeviceLike = None) -> Tuple[GaussianParams, GaussianStats]:
    """Initialise from a point cloud (reference create_from_pcd :155-184).

    Scale = log(sqrt(mean 3-NN squared distance)); opacity = logit(0.1);
    identity rotation; zero normals.
    """
    from ..ops.knn import mean_knn_dist2
    from ..ops.sh import rgb_to_sh

    dev = resolve_device(device)
    n = points.shape[0]
    assert n <= capacity, f"{n} points exceed capacity {capacity}"
    M = capacity
    f32 = dict(dtype=torch.float32, device=dev)

    xyz = torch.zeros((M, 3), **f32)
    xyz[:n] = torch.as_tensor(points, **f32)
    f_dc = torch.zeros((M, 1, 3), **f32)
    f_dc[:n, 0] = rgb_to_sh(torch.as_tensor(colors, **f32))
    f_rest = torch.zeros((M, 15, 3), **f32)

    alive = torch.zeros(M, dtype=torch.bool, device=dev)
    alive[:n] = True
    # only live rows are queried: dead rows' scales stay 0 (never read)
    d2 = mean_knn_dist2(xyz[:n], alive[:n], k=3).clamp_min(1e-7)
    scaling = torch.zeros((M, 3), **f32)
    scaling[:n] = torch.log(torch.sqrt(d2))[:, None]

    rotation = torch.zeros((M, 4), **f32)
    rotation[:, 0] = 1.0
    opacity = torch.full((M, 1), float(inverse_sigmoid(torch.tensor(0.1))), **f32)
    params = GaussianParams(
        xyz=xyz, f_dc=f_dc, f_rest=f_rest, scaling=scaling, rotation=rotation,
        opacity=opacity, normal=torch.zeros((M, 3), **f32),
        density_thres=torch.tensor(float(init_density_threshold), **f32))
    stats = GaussianStats(
        alive=alive, max_radii2d=torch.zeros(M, **f32),
        xyz_grad_accum=torch.zeros(M, **f32), denom=torch.zeros(M, **f32),
        gaussian_center=torch.zeros(3, **f32),
        gaussian_scale=torch.tensor(1.0, **f32))
    return params, stats


def update_scale_center(params: GaussianParams, stats: GaussianStats,
                        gaussian_ratio: float,
                        fixed_center: Optional[list] = None) -> GaussianStats:
    """Fit the DPSR normalisation frame around the live point set
    (reference update_scale_center :94-120)."""
    big = 1e9
    alive = stats.alive[:, None]
    mins = torch.where(alive, params.xyz, big).amin(0)
    maxs = torch.where(alive, params.xyz, -big).amax(0)
    if fixed_center is None:
        center = (mins + maxs) / 2.0
        half = torch.stack([maxs - center, center - mins]).abs().max()
    else:
        center = torch.as_tensor(fixed_center, dtype=torch.float32,
                                 device=params.xyz.device)
        half = torch.maximum((maxs - center).abs(), (center - mins).abs()).max()
    return stats._replace(gaussian_center=center, gaussian_scale=half * gaussian_ratio)


# --- PLY files (reference schema: save_ply :253-289 / load_ply :296-362) ----

def _ply_property_list(n_rest: int):
    props = ["x", "y", "z", "nx", "ny", "nz"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(3 * n_rest)]
    props += ["opacity"]
    props += [f"scale_{i}" for i in range(3)]
    props += [f"rot_{i}" for i in range(4)]
    props += ["density_thres", "gaussian_center", "gaussian_scale"]
    return props


def save_ply(path: str, params: GaussianParams, stats: GaussianStats):
    """The live Gaussians as a binary little-endian PLY in the JAX package's
    layout, byte for byte (dgmesh_tpu/models/gaussians.py::save_ply): the
    reference's extended schema (gaussian_model_dpsr_dynamic_anchor.py:253-289)
    with per-vertex density_thres, gaussian_center (the centre's mean) and
    gaussian_scale columns, and the centre itself in a header comment."""
    import os
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    idx = np.nonzero(host(stats.alive))[0]
    n = len(idx)
    n_rest = params.f_rest.shape[1]
    f_dc = host(params.f_dc)[idx].transpose(0, 2, 1).reshape(n, 3)
    f_rest = host(params.f_rest)[idx].transpose(0, 2, 1).reshape(n, 3 * n_rest)
    center = host(stats.gaussian_center)
    dt = np.full((n, 1), float(params.density_thres), np.float32)
    gc = np.tile(center.mean(), (n, 1)).astype(np.float32)
    gs = np.full((n, 1), float(stats.gaussian_scale), np.float32)
    data = np.concatenate([host(params.xyz)[idx], host(params.normal)[idx], f_dc, f_rest,
                           host(params.opacity)[idx], host(params.scaling)[idx],
                           host(params.rotation)[idx], dt, gc, gs], axis=1).astype("<f4")
    props = _ply_property_list(n_rest)
    assert data.shape[1] == len(props)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        header = ["ply", "format binary_little_endian 1.0",
                  f"comment gaussian_center {center[0]} {center[1]} {center[2]}",
                  f"element vertex {n}"]
        header += [f"property float {p}" for p in props]
        header += ["end_header"]
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def load_ply(path: str, capacity: int,
             device: DeviceLike = None) -> Tuple[GaussianParams, GaussianStats]:
    """Read a PLY of ``save_ply``'s layout (or the reference's, without the
    extra columns) into ``capacity`` padded slots, the live ones first."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        props, center, n = [], None, 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                props.append(line.split()[-1])
            elif line.startswith("comment gaussian_center"):
                center = np.array([float(v) for v in line.split()[-3:]], np.float32)
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(n * len(props) * 4), dtype="<f4").reshape(n, len(props))
    col = {p: i for i, p in enumerate(props)}
    M = capacity
    if n > M:
        raise ValueError(f"{path}: {n} points exceed the capacity {M}")
    n_rest = sum(1 for p in props if p.startswith("f_rest_")) // 3
    f32 = dict(dtype=torch.float32, device=dev)

    def grab(names):
        return data[:, [col[p] for p in names]]

    def pad(x, tail):
        out = np.zeros((M,) + tail, np.float32)
        out[:n] = x.reshape((n,) + tail)
        return torch.as_tensor(out, **f32)

    f_dc = grab([f"f_dc_{i}" for i in range(3)]).reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = grab([f"f_rest_{i}" for i in range(3 * n_rest)]).reshape(n, 3, n_rest)
    dt = float(data[0, col["density_thres"]]) if "density_thres" in col else 0.0
    gsc = float(data[0, col["gaussian_scale"]]) if "gaussian_scale" in col else 1.0
    params = GaussianParams(
        xyz=pad(grab(["x", "y", "z"]), (3,)), f_dc=pad(f_dc, (1, 3)),
        f_rest=pad(f_rest.transpose(0, 2, 1), (n_rest, 3)),
        scaling=pad(grab([f"scale_{i}" for i in range(3)]), (3,)),
        rotation=pad(grab([f"rot_{i}" for i in range(4)]), (4,)),
        opacity=pad(grab(["opacity"]), (1,)), normal=pad(grab(["nx", "ny", "nz"]), (3,)),
        density_thres=torch.tensor(dt, **f32))
    alive = torch.zeros(M, dtype=torch.bool, device=dev)
    alive[:n] = True
    stats = GaussianStats(
        alive=alive, max_radii2d=torch.zeros(M, **f32), xyz_grad_accum=torch.zeros(M, **f32),
        denom=torch.zeros(M, **f32),
        gaussian_center=torch.as_tensor(np.zeros(3, np.float32) if center is None else center,
                                        **f32),
        gaussian_scale=torch.tensor(gsc, **f32))
    return params, stats


def random_init_cloud(rng: np.random.Generator, n: int = 100_000, extent: float = 1.3):
    """The random init cloud of a dataset that ships no SfM points
    (reference dataset_readers.py:330-341): uniform in a cube of side
    2·extent, random colours."""
    points = (rng.random((n, 3)) * 2 - 1) * extent
    colors = rng.random((n, 3))
    return points.astype(np.float32), colors.astype(np.float32)
