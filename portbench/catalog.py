"""Finding a cell's pieces by name.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric is a file of its own under the benchmark's folder,
found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.yaml``: the configuration as it is run (``run``: the
  port's config, which each cell and run complete), the recipe it derives
  from, the Example trainer (``module:Class``), the reference module and the
  name of its FLOP function;
* ``traffic/<traffic>.json``: ranks, batch per rank, pool size in batches,
  checked and warm-up steps;
* ``workloads/<cell>.json``: configuration, traffic, chips, ``why`` and the
  limits of the numbers that decide ``correct``;
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` with its
  ``UNIT``, ``BETTER``, ``LAYER``, ``MOVES`` and ``SOURCE``;
* ``reference/<config>.py``: the plain reference, its FLOP and byte
  functions.

``BENCHMARK.json`` sits beside the benchmark's folder; it says which
per-layer metrics a cell reports.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

import yaml

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    why: str
    limits: dict
    root: Path

    @property
    def ranks(self):
        return int(self.traffic["ranks"])

    @property
    def per_rank(self):
        return int(self.traffic["batch_per_rank"])

    @property
    def global_batch(self):
        return self.ranks * self.per_rank

    @property
    def pool_images(self):
        return int(self.traffic["pool_batches"]) * self.global_batch

    def run_config(self, seed, log_dir):
        """The port's config for one run of this cell."""
        cfg = copy.deepcopy(self.config["run"])
        cfg["experiment"].update(seed=int(seed), log_dir=str(log_dir), debug=True)
        cfg["dataset"].update(batch_size=self.global_batch)
        return cfg


def load_cell(name, root=HERE):
    root = Path(root)
    with open(root / "workloads" / f"{name}.json") as f:
        spec = json.load(f)
    with open(root / "configs" / f"{spec['config']}.yaml") as f:
        config = yaml.safe_load(f)
    with open(root / "traffic" / f"{spec['traffic']}.json") as f:
        traffic = json.load(f)
    cell = Cell(name, config, traffic, int(spec["chips"]), spec["why"],
                dict(spec.get("limits", {})), root)
    if cell.ranks != cell.chips:
        raise ValueError(f"{name}: traffic {spec['traffic']} runs {cell.ranks} "
                         f"ranks on {cell.chips} chips")
    return cell


def _module_from_file(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_module(cell):
    """``reference/<config['reference']>.py``, imported as a module of the
    package whose folder holds it (its ``common`` beside it)."""
    ref = cell.config["reference"]
    if cell.root == HERE:
        return importlib.import_module(f"{__package__}.reference.{ref}")
    return _module_from_file(cell.root / "reference" / f"{ref}.py",
                             f"{__package__}.reference.{ref}")


def trainer_class(cell):
    """The Example trainer that the configuration names (``module:Class``)."""
    module, cls = cell.config["trainer"].split(":")
    return getattr(importlib.import_module(module), cls)


def load_metric(name, root=HERE):
    return _module_from_file(Path(root) / "metrics" / f"{name}.py",
                             f"{__package__}_metric_{name.replace('.', '_')}")


def benchmark_spec(root=HERE):
    with open(Path(root).parent / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(entry, cell_name):
    return "workloads" not in entry or cell_name in entry["workloads"]


def cell_metrics(cell, kind):
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports."""
    spec = benchmark_spec(cell.root)
    return [m for m in spec[kind] if _applies(m, cell.name)]
