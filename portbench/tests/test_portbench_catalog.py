"""The benchmark's files against ``BENCHMARK.json`` and against each other,
discovery by name, and what the benchmark may import."""

from __future__ import annotations

import ast
import json
import re
import shutil

import pytest

from portbench import catalog
from portbench.cell import FORBIDDEN, forbidden_modules

HERE = catalog.HERE
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) < 64 * 1024
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    chips4 = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert chips4 <= max(1, len(SPEC["workloads"]) // 4)


def test_names_units_and_text():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for text in ([w["why"] for w in SPEC["workloads"]] + [c["why"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_match(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    c = catalog.load_cell(cell)
    spec = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    assert (spec["config"], spec["traffic"], spec["chips"], spec["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert c.chips == c.ranks and c.chips in (1, 4)
    assert c.pool_images >= 8 * c.global_batch
    assert c.limits and set(c.limits) <= {"loss_gap", "grad_gap", "change_gap",
                                          "grad_gap_median", "change_gap_median"}
    assert all(v > 0 for v in c.limits.values())
    reported = {m["name"] for m in catalog.cell_metrics(c, "end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert catalog.cell_metrics(c, "per_layer")


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_files(config):
    entry = next(c for c in SPEC["configs"] if c["name"] == config)
    assert entry["file"] == f"portbench/configs/{config}.yaml"
    import yaml

    cfg = yaml.safe_load((HERE.parent / entry["file"]).read_text())
    assert cfg["name"] == config and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert any(w["config"] == config for w in SPEC["workloads"])
    ref = catalog.reference_module(catalog.load_cell(
        next(w["name"] for w in SPEC["workloads"] if w["config"] == config)))
    assert callable(getattr(ref, cfg["flops"])) and callable(ref.build)


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_readers_declare_what_the_spec_says(metric):
    m = catalog.load_metric(metric["name"])
    assert (m.UNIT, m.BETTER, m.LAYER, m.MOVES, m.SOURCE) == (
        metric["unit"], metric["better"], metric["layer"], metric["moves"], metric["source"])
    assert metric["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_are_named_alike():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a cell and a metric added as files
    are picked up with no edit to a file that is there."""
    root = tmp_path / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "reference"):
        shutil.copytree(HERE / sub, root / sub, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    (root / "configs" / "bcnn_wide.yaml").write_text(
        (HERE / "configs" / "bcnn_vgg16_s2.yaml").read_text().replace(
            "name: bcnn_vgg16_s2", "name: bcnn_wide"))
    (root / "traffic" / "train_b16.json").write_text(json.dumps(
        {"ranks": 1, "batch_per_rank": 16, "pool_batches": 8, "checked_steps": 3,
         "warmup_steps": 4}))
    (root / "workloads" / "bcnn_wide.train_b16.json").write_text(json.dumps(
        {"config": "bcnn_wide", "traffic": "train_b16", "chips": 1, "why": "added",
         "limits": {"loss_gap": 1, "grad_gap": 1, "change_gap": 1}}))
    (root / "metrics" / "step_count.py").write_text(
        'UNIT = "steps"\nBETTER = "higher"\nLAYER = "trainer loop"\n'
        'MOVES = "train_images_per_sec"\nSOURCE = "program_counter"\n\n\n'
        "def read(run):\n    return float(run.steps)\n")
    spec["workloads"].append({"name": "bcnn_wide.train_b16", "config": "bcnn_wide",
                              "traffic": "train_b16", "chips": 1, "why": "added"})
    spec["per_layer"].append({"name": "step_count", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "trainer loop",
                              "moves": "train_images_per_sec",
                              "workloads": ["bcnn_wide.train_b16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = catalog.load_cell("bcnn_wide.train_b16", root)
    assert cell.config["name"] == "bcnn_wide" and cell.global_batch == 16
    assert cell.run_config(5, "x")["dataset"]["batch_size"] == 16
    names = [m["name"] for m in catalog.cell_metrics(cell, "per_layer")]
    assert "step_count" in names and "batch_norm_ms" not in names
    assert catalog.load_metric("step_count", root).read(type("R", (), {"steps": 7})) == 7.0
    assert catalog.trainer_class(cell).__name__ == "BCNNTrainer"
    assert catalog.reference_module(cell).train_flops_per_image() > 0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_imports(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    if "reference" in path.relative_to(HERE).parts:
        assert "hawkeye_tpu_torch" not in tops, path


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "hawkeye_tpu_torch_x", types.ModuleType("x"))
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert forbidden_modules() == ["flax"]
