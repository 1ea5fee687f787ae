"""The check that decides ``correct``, driven through the harness at a tiny
size on the CPU (the harness's look for a card skipped): the reference
agrees with the port, a sound run is correct, and each fault that a
training cell can have, planted in the timed path, makes ``correct``
false; the control (the reference in float8 in the program's place) reads
above the limits. A card test reads the control at a cell's own size."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import catalog, cell, check, probe
from portbench.launch import free_port, rank_env
from portbench.reference.common import reference_steps
from portbench.tests import tiny

# at the tiny size with the port in float32 the sound readings are ~1e-6
# (BCNN: the same init, draws and arithmetic); every fault reads 1e-2 or more
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}
BCNN = "bcnn_vgg16_s2.train_b128"
SEED = 2**31 + 977  # larger than 32 signed bits


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.tiny_bench(tmp_path_factory.mktemp("bench"))
    for name in (BCNN, "baseline_resnet50_448.train_b128"):
        tiny.set_limits(r, name, LIMITS)
    # a cell on two ranks, added as files
    (r / "traffic" / "dp2_tiny.json").write_text(json.dumps(
        {"ranks": 2, "batch_per_rank": tiny.BATCH, "pool_batches": 2,
         "checked_steps": 3, "warmup_steps": 2}))
    (r / "workloads" / "bcnn_vgg16_s2.dp2_tiny.json").write_text(json.dumps(
        {"config": "bcnn_vgg16_s2", "traffic": "dp2_tiny", "chips": 2,
         "why": "two gloo ranks", "limits": LIMITS}))
    return r


def run_cell(root, name, fault=None, monkeypatch=None, traced=False):
    monkeypatch.setattr(probe, "instrument", tiny.patched_instrument(fault))
    return cell.run_rank(catalog.load_cell(name, root), SEED, 0.2, traced,
                         torch.device("cpu"), time.perf_counter(), log=lambda *a, **k: None)


def test_sound_run_is_correct(root, monkeypatch):
    result = run_cell(root, BCNN, None, monkeypatch, traced=True)
    assert result["correct"], result["checks"]
    assert result["checks"]["loss_gap"]["value"] < 1e-6
    assert list(result)[-1] == "checks"
    assert result["failed"] == 0 and result["attempted"] > 0
    assert {"data_wait_ms", "host_step_ms", "train_mfu"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "label_altered"])
def test_fault_is_not_correct(root, monkeypatch, fault):
    result = run_cell(root, BCNN, fault, monkeypatch)
    assert not result["correct"], (fault, result["checks"])


@pytest.mark.parametrize("where", ["reference", "metric_reader"])
def test_jax_loaded_after_the_window_refuses_the_result(root, monkeypatch, where):
    """The look for JAX is the run's last step: a module that the reference
    or a per-layer reader loads is found, and no result comes back."""

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if where == "reference":
        readings = cell.reference_readings
        monkeypatch.setattr(cell, "reference_readings",
                            lambda *a, **k: load_jax() or readings(*a, **k))
    else:
        load_metric = catalog.load_metric
        monkeypatch.setattr(catalog, "load_metric", lambda *a, **k: load_jax() or
                            load_metric(*a, **k))
    with pytest.raises(cell.ForbiddenModules, match="jax"):
        run_cell(root, BCNN, None, monkeypatch, traced=where == "metric_reader")


def _dp_procs(root, fault):
    port = free_port()
    args = [sys.executable, "-m", "portbench.tests.dp_worker", str(root),
            "bcnn_vgg16_s2.dp2_tiny", str(SEED)] + ([fault] if fault else [])
    procs = [subprocess.Popen(args, env=dict(os.environ, **rank_env(r, 2, port)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    return [p.returncode for p in procs], outs


def _dp_run(root, fault):
    codes, outs = _dp_procs(root, fault)
    assert codes == [0, 0], [o[1][-3000:] for o in outs]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_two_ranks(root, fault):
    result = _dp_run(root, fault)
    assert result["device"]["count"] == 2
    assert result["correct"] is (fault is None), result["checks"]


def test_jax_on_a_rank_other_than_0_fails_that_rank(root):
    codes, outs = _dp_procs(root, "jax_on_rank_1")
    assert codes[1] != 0 and "ForbiddenModules" in outs[1][1], outs[1][1][-3000:]


def test_reference_agrees_with_the_port_in_float64(root, monkeypatch):
    """ResNet-50 with Adam: in float32 the init's chaotic backward and
    Adam's sign-like first steps turn rounding into 1e-3; in float64 the
    first loss and gradient agree to rounding."""
    from portbench.reference import common

    def instrument(trainer, spans):
        tiny.float32_port(trainer)
        for m in trainer.model.modules():
            if isinstance(getattr(m, "dtype", None), torch.dtype):
                m.dtype = torch.float64
        trainer.model.double()
        trainer.model.fc.register_forward_pre_hook(lambda m, a: (a[0].double(),))
        return orig(trainer, spans)

    orig = probe.instrument
    monkeypatch.setattr(probe, "instrument", instrument)
    augment, init = common.augment, common.lecun_init
    monkeypatch.setattr(common, "augment", lambda *a: augment(*a).double())
    monkeypatch.setattr(common, "lecun_init", lambda m, g: init(m, g).double())
    seen = {}
    readings = check.readings
    monkeypatch.setattr(check, "readings", lambda p, r: seen.setdefault("v", (p, r)) and readings(p, r))
    cell.run_rank(catalog.load_cell("baseline_resnet50_448.train_b128", root), SEED, 0.2,
                  False, torch.device("cpu"), time.perf_counter(), log=lambda *a, **k: None)
    prog, ref = seen["v"]
    assert prog["losses"][0] == pytest.approx(ref["losses"][0], rel=1e-6)
    gaps = check.readings(prog, ref)
    assert gaps["grad_gap"] < 1e-5, gaps


def test_control_reads_above_the_limits(root):
    """The reference in float8 in the program's place, against the float32
    reference, at the tiny size: over the limit on at least one number."""
    c = catalog.load_cell(BCNN, root)
    run_cfg = c.run_config(SEED % 2**32, "unused")
    from portbench import data

    images, labels = data.make_pool(c.pool_images, tiny.DECODE, tiny.CLASSES, SEED % 2**32,
                                    torch.device("cpu"))
    sampler = data.WindowSampler(c.pool_images, c.global_batch, SEED % 2**32)
    sampler.plan(3)
    batches = list(sampler)
    ref_mod = catalog.reference_module(c)
    args = (ref_mod, run_cfg, images, labels, batches, SEED % 2**32, c.per_rank,
            torch.device("cpu"))
    ref = reference_steps(*args)
    control = check.readings(reference_steps(*args, precision="fp8"), ref)
    ok, _ = check.judge(control, LIMITS)
    assert not ok, control


@pytest.mark.cuda
def test_control_at_cell_size_on_the_card():
    """The control and the faults at the cell's own size (run on the card:
    ``python -m pytest portbench/tests -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs only on the card")
    out = subprocess.run([sys.executable, "-m", "portbench.calibrate", "--workload",
                          BCNN, "--seeds", "11", "--controls", "1"],
                         capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = catalog.load_cell(BCNN).limits
    assert check.judge(line["sound"], limits)[0], line
    assert not check.judge(line["control"], limits)[0], line
    assert not check.judge(line["half_batch"], limits)[0], line
