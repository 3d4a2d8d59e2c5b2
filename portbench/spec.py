"""Finding the pieces of a cell by name.

``BENCHMARK.json`` names each cell's configuration and traffic; everything
else is found from those names, so a later cell, configuration, traffic mix
or per-layer metric is added as files, without editing one:

- ``portbench/configs/<config>.json``: the configuration (the frozen config
  groups, the cameras, the state's size, ``reduced`` and ``assumed``);
- ``portbench/workloads/<traffic>.json``: the traffic mix's parameters and
  its ``kind``;
- ``portbench/traffic/<kind>.py``: the one generator of a kind, which runs it;
- ``portbench/limits/<cell>.json``: the limit of each number compared;
- ``portbench/metrics/<metric>.py``: the reader of a per-layer metric; a
  metric ``<base>.<suffix>`` with no file of its own is read by
  ``<base>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType, SimpleNamespace

PACKAGE = "portbench"


class Spec:
    """One cell of ``<root>/BENCHMARK.json`` with its files."""

    def __init__(self, root: str, workload: str):
        self.root = os.path.abspath(root)
        self.bench = self.read_json("BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.cell = cells[workload]
        self.name = workload
        self.config = self.read_json(PACKAGE, "configs", self.cell["config"] + ".json")
        self.mix = self.read_json(PACKAGE, "workloads", self.cell["traffic"] + ".json")
        self.kind = self.mix["kind"]
        self.limits = self.read_json(PACKAGE, "limits", workload + ".json")

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def read_json(self, *parts: str):
        with open(self.path(*parts)) as f:
            return json.load(f)

    def traffic_module(self) -> ModuleType:
        return load_file(self.path(PACKAGE, "traffic", self.kind + ".py"),
                         f"{PACKAGE}_traffic_{self.kind}")

    def metrics(self, trace: bool):
        """The cell's metrics: its end-to-end ones, or with ``trace`` its
        per-layer ones (those whose ``workloads`` list it, or that list none
        and move an end-to-end metric the cell reports)."""
        e2e = [m for m in self.bench["end_to_end"] if self._has(m)]
        if not trace:
            return e2e
        reported = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def _has(self, m: dict) -> bool:
        return "workloads" not in m or self.name in m["workloads"]

    def reader(self, metric: str) -> ModuleType:
        """The reader module of a per-layer metric."""
        d = self.path(PACKAGE, "metrics")
        own = os.path.join(d, metric + ".py")
        base = os.path.join(d, metric.split(".")[0] + ".py")
        path = own if os.path.exists(own) else base
        return load_file(path, f"{PACKAGE}_metric_{os.path.basename(path)[:-3]}")


def load_file(path: str, name: str) -> ModuleType:
    """Import a Python file by path (names may hold dots)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_program() -> SimpleNamespace:
    """The modules of the system under test (``dgmesh_torch``) that the
    harness drives or wraps."""
    base = "dgmesh_torch"
    mods = dict(cameras="cameras", config="config", gaussians="models.gaussians",
                state="train.state", step="train.step", loop="train.loop",
                testing="eval.testing", splat_kernels="ops.splat_kernels",
                raster_kernels="ops.mesh_raster_kernels")
    return SimpleNamespace(**{k: importlib.import_module(f"{base}.{v}")
                              for k, v in mods.items()})


def build_config(P, conf: dict):
    """The configuration's frozen groups as the program's Config."""
    return P.config.Config.from_dict(conf["config"])
