"""Training CLI (reference dgmesh/train.py __main__ :858-949; the port's copy
of dgmesh_tpu/cli/train.py).

    python -m dgmesh_torch.cli.train --config configs/synthetic-quality-288.yaml \\
        -s DATA -m OUT [--device cuda]

The reference's flag surface (flat names from the parameter groups, the
YAML taking precedence over the command line), its fixed seed (:888-891),
the cfg dump (:919-934), checkpoints at --save_iterations and at the end,
and a final test pass.  ``--profile_iters N`` profiles the first N
iterations with torch.profiler (a Chrome trace under OUT/profile, holding
the program's spans of dgmesh_torch/tracing.py, and the top operators
printed; ``python3 -m portbench.spans OUT/profile/trace.json`` tabulates the
spans).  ``--export_meshes N`` writes the dynamic mesh
sequence after the test pass: N meshes at uniform times under OUT/meshes,
which ``cli.mesh_evaluation`` holds to the GT meshes.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Optional

import numpy as np
import torch


def parse(argv=None):
    from ..config import add_config_args, config_from_args
    parser = argparse.ArgumentParser(description="dgmesh_torch trainer")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--seed", type=int, default=6666)       # reference train.py:888
    parser.add_argument("--start_checkpoint", type=str, default=None,
                        help="a model folder whose checkpoint/ to resume from (the "
                             "port's state_N.pt, or the JAX package's state_N.msgpack)")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--quit_after", type=int, default=None,
                        help="stop after N iterations")
    parser.add_argument("--profile_iters", type=int, default=0,
                        help="profile the first N iterations with torch.profiler")
    parser.add_argument("--log_images", action="store_true",
                        help="image and mesh dumps to logs/ and logs_geo/ at log_every "
                             "(reference train.py:323-386)")
    parser.add_argument("--export_meshes", type=int, default=0,
                        help="export the mesh at N uniform times to OUT/meshes after "
                             "training (reference train.py:389-423)")
    add_config_args(parser)
    args = parser.parse_args(argv)
    return args, config_from_args(args, args.config)


def _profiled(trainer, model_path: str, **train_kw):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = os.path.join(model_path, "profile")
    os.makedirs(out, exist_ok=True)
    with profile(activities=acts) as prof:
        trainer.train(**train_kw)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    key = "self_cuda_time_total" if trainer.device.type == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=25), flush=True)


def main(argv=None, device: Optional[str] = None):
    """Train from the command line ``argv``; ``device`` overrides --device."""
    from ..data.scene import Scene
    from ..device import resolve_device
    from ..eval.testing import export_dynamic_meshes, run_testing, write_test_results
    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.loop import Trainer

    args, cfg = parse(argv)
    dev = resolve_device(device or args.device)
    random.seed(args.seed)
    np.random.seed(args.seed % (2 ** 31))
    torch.manual_seed(args.seed)
    if not cfg.model.model_path:
        import uuid
        cfg.model.model_path = os.path.join("./output/", str(uuid.uuid4())[:10])
    os.makedirs(cfg.model.model_path, exist_ok=True)
    cfg.save(os.path.join(cfg.model.model_path, "cfg_args.json"))
    print(f"Output folder: {cfg.model.model_path} (device {dev})", flush=True)

    scene = Scene(cfg, shuffle=True, seed=args.seed)
    state = None
    if args.start_checkpoint:
        state = load_checkpoint(cfg, args.start_checkpoint, device=dev)
        print(f"Resumed from {args.start_checkpoint} at step {int(state.step)}", flush=True)
    trainer = Trainer(cfg, scene, state=state, seed=args.seed, device=dev)
    iterations = args.quit_after or cfg.optimization.iterations
    save_at = set(args.save_iterations or [iterations])
    first_iter = int(trainer.state.step) + 1
    log_every = min(cfg.optimization.log_every, 100)

    def on_log(m):
        with open(os.path.join(cfg.model.model_path, "train_log.jsonl"), "a") as f:
            f.write(json.dumps(m) + "\n")

    if args.profile_iters:
        _profiled(trainer, cfg.model.model_path,
                  iterations=min(first_iter + args.profile_iters - 1, iterations),
                  log_every=log_every, first_iter=first_iter, on_log=on_log)
        first_iter = int(trainer.state.step) + 1
    trainer.train(iterations=iterations, log_every=log_every, first_iter=first_iter,
                  on_log=on_log,
                  image_log_every=cfg.optimization.log_every if args.log_images else 0,
                  image_log_dir=cfg.model.model_path,
                  save_at={i for i in save_at if i < iterations},
                  save_dir=cfg.model.model_path)
    save_checkpoint(trainer.state, cfg.model.model_path, iterations)
    print("Training complete.", flush=True)

    results = None
    if scene.test_cameras:             # reference train.py:540-555 → testing()
        results = run_testing(cfg, trainer, scene)
        write_test_results(results, os.path.join(cfg.model.model_path, "test_results"))
        print("Test results:", results, flush=True)
    if args.export_meshes > 0:         # reference train.py:389-423
        export_dynamic_meshes(cfg, trainer, scene, os.path.join(cfg.model.model_path, "meshes"),
                              n_frames=args.export_meshes)
    return trainer, results


if __name__ == "__main__":
    main()
