"""The port's config loader on the shipped real-data YAMLs."""

import argparse
import glob
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from dgmesh_torch.config import config_from_args  # noqa: E402
from dgmesh_torch.train.state import net_lrs  # noqa: E402

REAL_DATA = sorted(str(Path(p).relative_to(ROOT)) for d in ("nerfies", "iphone", "neural-actor")
                   for p in glob.glob(str(ROOT / "configs" / d / "*.yaml")))


def test_the_six_real_data_yamls_are_found():
    assert len(REAL_DATA) == 6


@pytest.mark.parametrize("path", REAL_DATA)
def test_real_data_yaml_learning_rates_are_numbers(path):
    """Every float field of a real-data YAML loads as a float (apperance_lr_final
    is written 8e-06, which YAML 1.1 reads as a string), and the nets' learning
    rates at the first and last iteration are finite and positive."""
    cfg = config_from_args(argparse.Namespace(), str(ROOT / path))
    o = cfg.optimization
    assert isinstance(o.apperance_lr_final, float) and isinstance(o.apperance_lr_init, float)
    if "nerfies" in path or "tiger" in path:
        assert o.apperance_lr_final == 8e-06 and o.apperance_lr_init == 0.0008
    for step in (0.0, float(o.iterations)):
        for lr in net_lrs(torch.tensor(step), cfg):
            assert math.isfinite(float(lr)) and float(lr) > 0, path
