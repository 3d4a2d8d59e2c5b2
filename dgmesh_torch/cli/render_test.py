"""Test-set rendering CLI (reference dgmesh/render_test.py :42-226; the
port's copy of dgmesh_tpu/cli/render_test.py).

    python -m dgmesh_torch.cli.render_test -m OUT [--iteration N] [--out DIR]

Loads the checkpoint (the latest, or --iteration) and the config the run
stored (cfg_args.json), renders the GS and mesh images of the test
cameras, writes them with the meshes, and prints the metrics.  The
reference's side-by-side GIF needs imageio and is not ported.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def main(argv=None, device: Optional[str] = None):
    """Render the test set of a trained model; ``device`` overrides --device."""
    from ..config import Config, add_config_args, config_from_args
    from ..data.scene import Scene
    from ..device import resolve_device
    from ..eval.testing import run_testing
    from ..train.checkpoint import load_checkpoint
    from ..train.loop import Trainer

    parser = argparse.ArgumentParser(description="dgmesh_torch test renders")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--out", type=str, default=None)
    add_config_args(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(device or args.device)
    cfg = config_from_args(args, args.config)
    stored = os.path.join(cfg.model.model_path, "cfg_args.json")
    if os.path.exists(stored):
        base = Config.load(stored)
        base.model.model_path = cfg.model.model_path
        cfg = base
    scene = Scene(cfg, shuffle=False)
    state = load_checkpoint(cfg, cfg.model.model_path, args.iteration, device=dev)
    trainer = Trainer(cfg, scene, state=state, device=dev)
    out_dir = args.out or os.path.join(cfg.model.model_path, "test_renders")
    results = run_testing(cfg, trainer, scene, save_dir=out_dir)
    print(results, flush=True)
    print("the side-by-side GIF of the reference is not written (it needs imageio)", flush=True)
    return results


if __name__ == "__main__":
    main()
