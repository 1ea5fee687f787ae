"""The readers of the port's own spans and counters, on a traced CPU run at
the tiny size: the host readers report, the device readers give None
without CUDA, and every reader gives None where the tracer's traced steps
are not the trace's or the port has no tracer. Two gloo ranks read the
collective counters exactly."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

import hawkeye_tpu_torch.utils
from hawkeye_tpu_torch.utils import trace
from portbench import catalog, cell, probe, program_spans
from portbench.launch import free_port, rank_env
from portbench.tests import tiny

BCNN = "bcnn_vgg16_s2.train_b128"
DP2 = "bcnn_vgg16_s2.dp2_tiny"
SEED = 2**31 + 1234
HOST = ("item_wait_ms", "collate_ms", "pin_ms")
DEVICE = ("forward_ms", "backward_ms", "norm_ms", "bn_allreduce_ms", "grad_allreduce_ms")
COUNTERS = ("collective_calls", "collective_mb")
# BCNN's VGG-16 trunk (convs with biases) and its 512^2 x 10 classifier at the
# tiny size: every float32 gradient in the one all-reduce of a step
BCNN_TINY_PARAMS = 14_714_688 + 512 * 512 * 10 + 10


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.tiny_bench(tmp_path_factory.mktemp("bench"))
    limits = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}
    tiny.set_limits(r, BCNN, limits)
    (r / "traffic" / "dp2_tiny.json").write_text(json.dumps(
        {"ranks": 2, "batch_per_rank": tiny.BATCH, "pool_batches": 2,
         "checked_steps": 3, "warmup_steps": 2}))
    (r / "workloads" / f"{DP2}.json").write_text(json.dumps(
        {"config": "bcnn_vgg16_s2", "traffic": "dp2_tiny", "chips": 2,
         "why": "two gloo ranks", "limits": limits}))
    spec_path = r.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    for m in spec["per_layer"]:
        if m["name"] in COUNTERS:
            m["workloads"].append(DP2)
    spec_path.write_text(json.dumps(spec))
    return r


def _record(steps):
    return types.SimpleNamespace(summary=types.SimpleNamespace(steps=steps))


def test_traced_run_reads_the_host_spans(root, monkeypatch):
    monkeypatch.setattr(probe, "instrument", tiny.patched_instrument())
    read = []  # what the readers got from the stretch's profiler events
    traced = program_spans._traced
    monkeypatch.setattr(program_spans, "_traced", lambda run: read.append(traced(run)) or read[-1])
    trace.reset()
    result = cell.run_rank(catalog.load_cell(BCNN, root), SEED, 0.2, True,
                           torch.device("cpu"), time.perf_counter(), log=lambda *a, **k: None)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for name in HOST:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "ms", name
    assert not set(metrics) & {*DEVICE, *COUNTERS}
    steps = trace.summary()["steps"]
    assert steps >= 5
    assert read and all(r is not None for r in read)
    assert read[-1]["steps"] == steps and read[-1]["spans"]["forward"]["calls"] == steps
    for name in DEVICE:  # the spans ran, but without CUDA there is no device time
        assert catalog.load_metric(name, root).read(_record(steps)) is None, name
    for name in HOST:  # another stretch than the tracer's
        assert catalog.load_metric(name, root).read(_record(steps + 1)) is None, name
    # a port without the tracer
    monkeypatch.delattr(hawkeye_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "hawkeye_tpu_torch.utils.trace", None)
    for name in (*HOST, *COUNTERS):
        assert catalog.load_metric(name, root).read(_record(steps)) is None, name
    trace.reset()


def test_two_ranks_read_the_collective_counters(root):
    port = free_port()
    args = [sys.executable, "-m", "portbench.tests.traced_dp_worker", str(root), DP2, str(SEED)]
    procs = [subprocess.Popen(args, env=dict(os.environ, **rank_env(r, 2, port)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-3000:] for o in outs]
    result = json.loads(outs[0][0].strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    assert metrics["collective_calls"] == {"value": 1.0, "unit": "calls"}  # no BatchNorm
    assert metrics["collective_mb"] == {"value": 4 * BCNN_TINY_PARAMS / 1e6, "unit": "MB"}
    assert all(metrics[n]["value"] > 0 for n in HOST)
