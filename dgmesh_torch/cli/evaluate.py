"""Evaluation from a saved checkpoint (the port's copy of
tools/eval_from_checkpoint.py).

    python -m dgmesh_torch.cli.evaluate -m OUT -s DATA [--iteration N] \\
        [--n_meshes 200] [--skip_cd] [--emd_samples 2048] [--device cuda]

The evaluation that ``cli.train`` runs at the end of a run, from the run's
checkpoint (the latest, or --iteration; the port's ``state_N.pt`` or the
JAX package's ``state_N.msgpack``), so that an interrupted run still gives
its quality numbers: ``run_testing`` into OUT/test_results (each test
view's renders and mesh, and test_result.txt), the dynamic mesh export of
--n_meshes frames into OUT/meshes, and, unless --skip_cd,
``cli.mesh_evaluation`` of those meshes against DATA/gt_eval with JAX's
recipe (--transforms DATA/transforms_train.json) into OUT/eval_results.txt.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="dgmesh_torch evaluation from a checkpoint")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("-s", "--source_path", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--n_meshes", type=int, default=200)
    parser.add_argument("--skip_cd", action="store_true")
    parser.add_argument("--emd_samples", type=int, default=2048)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; 'cpu' on request)")
    return parser.parse_args(argv)


def main(argv=None, device: Optional[str] = None):
    """Evaluate a run from its checkpoint; ``device`` overrides --device.
    Returns run_testing's results and the mesh evaluation's per-frame
    (cd, emd) pairs (None with --skip_cd)."""
    from ..config import Config
    from ..data.scene import Scene
    from ..device import resolve_device
    from ..eval.testing import export_dynamic_meshes, run_testing, write_test_results
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import Trainer
    from . import mesh_evaluation

    args = parse(argv)
    dev = resolve_device(device or args.device)
    cfg = Config.load(os.path.join(args.model_path, "cfg_args.json"))
    cfg.model.model_path = args.model_path
    cfg.model.source_path = args.source_path

    scene = Scene(cfg, shuffle=False)
    state = load_checkpoint(cfg, args.model_path, args.iteration, device=dev)
    trainer = Trainer(cfg, scene, state=state, device=dev)
    print(f"loaded checkpoint at step {int(trainer.state.step)}", flush=True)

    test_dir = os.path.join(args.model_path, "test_results")
    results = run_testing(cfg, trainer, scene, save_dir=test_dir)
    write_test_results(results, test_dir)
    print(results, flush=True)

    mesh_dir = os.path.join(args.model_path, "meshes")
    export_dynamic_meshes(cfg, trainer, scene, mesh_dir, n_frames=args.n_meshes)
    print(f"exported {args.n_meshes} meshes to {mesh_dir}", flush=True)

    pairs = None
    if not args.skip_cd:
        out = os.path.join(args.model_path, "eval_results.txt")
        pairs = mesh_evaluation.main(
            ["--gt_dir", os.path.join(args.source_path, "gt_eval"), "--pred_dir", mesh_dir,
             "--transforms", os.path.join(args.source_path, "transforms_train.json"),
             "--emd_samples", str(args.emd_samples), "--out", out], device=dev)
        with open(out) as f:
            print(f.read().splitlines()[-3:], flush=True)
    return results, pairs


if __name__ == "__main__":
    main()
