"""Mesh quality evaluation CLI (reference dgmesh/mesh_evaluation.py :31-248;
the port's copy of dgmesh_tpu/cli/mesh_evaluation.py).

    python -m dgmesh_torch.cli.mesh_evaluation --gt_dir DATA/gt_eval \\
        --pred_dir OUT/meshes [--transforms DATA/transforms_train.json] [--device cuda]

Per-frame Chamfer and EMD between the GT meshes (.obj) and the predicted
ones (.ply), with the per-method coordinate-frame rotations of the
reference's utils/pose_utils.py:102-138 (``pose_utils.ROTATIONS``) and the
optional camera-origin shift from transforms_train.json (:136-142); writes
eval_results.txt.
The Chamfer distance runs on the unpadded vertex sets (JAX pads them to
buckets of 16,384 with a valid mask only to spare its compiler; the
masked result is the same).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np
import torch

from ..ops.chamfer import chamfer, emd_sinkhorn
from ..pose_utils import ROTATIONS

BLENDER2OPENCV = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)


def load_mesh_any(path: str):
    from ..utils_io import read_mesh_ply, read_obj
    if path.endswith(".obj"):
        return read_obj(path)
    return read_mesh_ply(path)


def sample_surface_np(verts, faces, n, seed=0):
    rng = np.random.default_rng(seed)
    tri = verts[faces]
    areas = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    p = areas / max(areas.sum(), 1e-12)
    fidx = rng.choice(len(faces), size=n, p=p)
    uv = rng.random((n, 2))
    su = np.sqrt(uv[:, :1])
    b = np.concatenate([1 - su, su * (1 - uv[:, 1:]), su * uv[:, 1:]], 1)
    t = verts[faces[fidx]]
    return (b[:, :, None] * t).sum(1).astype(np.float32)


def camera_origin(transforms_path: str) -> np.ndarray:
    """The first frame's camera position in the OpenCV frame, from a
    transforms_train.json: the GT meshes' shift (reference :136-142)."""
    with open(transforms_path) as f:
        meta = json.load(f)
    c2w = np.asarray(meta["frames"][0]["transform_matrix"], np.float32)
    return BLENDER2OPENCV @ c2w[:3, 3]


def load_pair(gt_path, pred_path, rotate, cam_origin=None):
    """The GT mesh shifted by ``cam_origin`` and the predicted one rotated
    into its frame: (gt verts, gt faces, pred verts, pred faces)."""
    gv, gf = load_mesh_any(gt_path)
    pv, pf = load_mesh_any(pred_path)
    if cam_origin is not None:
        gv = gv - cam_origin[None].astype(np.float32)
    return gv, gf, (rotate @ pv.T).T, pf


def eval_pair(gt_path, pred_path, rotate, cam_origin=None, emd_samples=8192,
              device: Optional[torch.device] = None):
    """reference eval_distance :31-95: CD on the vertices (the sum of both
    directions' means, halved), EMD on ``emd_samples`` surface samples
    (seeds 0 and 1), on ``device`` (cuda unless the caller asks for the
    CPU).  Returns (cd, emd) as floats."""
    from ..device import resolve_device
    dev = resolve_device(device)
    gv, gf, pv, pf = load_pair(gt_path, pred_path, rotate, cam_origin)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=dev)

    cd = float(chamfer(t(gv), t(pv))[0]) / 2.0   # (mean_a2b + mean_b2a)/2, chamferDist's use
    gs = sample_surface_np(gv, gf, emd_samples, 0)
    ps = sample_surface_np(pv, pf, emd_samples, 1)
    emd = float(emd_sinkhorn(t(gs), t(ps)))
    return cd, emd


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="dgmesh_torch mesh evaluation")
    parser.add_argument("--gt_dir", required=True,
                        help="directory of per-frame GT .obj meshes")
    parser.add_argument("--pred_dir", required=True,
                        help="directory of per-frame predicted .ply meshes")
    parser.add_argument("--method", default="dgmesh", choices=list(ROTATIONS))
    parser.add_argument("--transforms", default=None,
                        help="transforms_train.json for camera-origin shift")
    parser.add_argument("--emd_samples", type=int, default=8192)
    parser.add_argument("--out", default="eval_results.txt")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; 'cpu' on request)")
    return parser.parse_args(argv)


def main(argv=None, device: Optional[str] = None):
    """Evaluate a predicted mesh sequence against the GT one; ``device``
    overrides --device.  Returns the per-frame (cd, emd) pairs."""
    from ..device import resolve_device
    args = parse(argv)
    dev = resolve_device(device or args.device)

    cam_origin = camera_origin(args.transforms) if args.transforms else None

    gts = sorted(f for f in os.listdir(args.gt_dir) if f.endswith(".obj"))
    preds = sorted(f for f in os.listdir(args.pred_dir) if f.endswith(".ply"))
    n = min(len(gts), len(preds))
    rot = ROTATIONS[args.method]

    pairs, lines = [], []
    for i in range(n):
        cd, emd = eval_pair(os.path.join(args.gt_dir, gts[i]),
                            os.path.join(args.pred_dir, preds[i]),
                            rot, cam_origin, args.emd_samples, dev)
        pairs.append((cd, emd))
        lines.append(f"frame {i}: CD {cd:.6f} EMD {emd:.6f}")
        print(lines[-1], flush=True)

    lines.append(f"mean CD {np.mean([p[0] for p in pairs]):.6f}")
    lines.append(f"mean EMD {np.mean([p[1] for p in pairs]):.6f}")
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(lines[-2], lines[-1], flush=True)
    return pairs


if __name__ == "__main__":
    main()
