"""Test-set rendering CLI (reference dgmesh/render_test.py :42-226; the
port's copy of dgmesh_tpu/cli/render_test.py).

    python -m dgmesh_torch.cli.render_test -m OUT [--iteration N] [--out DIR]

Loads the checkpoint (the latest, or --iteration) and the config the run
stored (cfg_args.json), renders the GS and mesh images of the test
cameras, writes them with the meshes, prints the metrics, and writes the
side-by-side GT | mesh GIF (test.gif) where imageio is installed (the
renders read back by ``utils_io.read_png``).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np


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
    write_side_by_side_gif(scene, out_dir)
    return results


def write_side_by_side_gif(scene, out_dir: str):
    """test.gif of GT | mesh render per test view (reference
    render_test.py :48-60), written when imageio imports; otherwise the skip
    is printed."""
    from ..utils_io import read_png
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        print(f"video export skipped: {e}", flush=True)
        return
    frames = []
    for i, cam in enumerate(scene.test_cameras):
        mesh_p = os.path.join(out_dir, f"mesh_{i:03d}.png")
        if os.path.exists(mesh_p):
            gt = (np.clip(cam.image, 0, 1) * 255).astype(np.uint8)
            frames.append(np.concatenate([gt, read_png(mesh_p)[..., :3]], axis=1))
    if frames:
        imageio.mimsave(os.path.join(out_dir, "test.gif"), frames, fps=10)


if __name__ == "__main__":
    main()
