"""The port's tracer (hawkeye_tpu_torch/utils/trace.py) and its sites, on the
CPU at a tiny size (ResNet-18 in float32 at 32x32, synthetic data, batch
4, two train steps through ``Trainer.train_epoch``):

* with no profiler recording, a step opens no range and registers no
  tensor hook, and the tracer keeps nothing;
* with one recording, the same two steps register no tensor hook either
  and leave bitwise the same parameters and statistics; each step has its
  spans as ``hk::`` ranges in the profiler's events (``batch_norm`` once a
  norm layer) and ``batch_norm.backward`` once a norm layer, read from the
  autograd nodes of its ops; they nest (``batch_norm`` in ``forward``,
  ``batch_norm.backward`` in ``backward``);
* ``summary`` gives each span the device time of the work launched while
  it was open, on any thread (made-up events: the CPU launches nothing);
* two gloo processes (``torch_trace_worker.py``) count 2 x norm layers + 1
  all-reduces a step, and the bytes that the model's shapes give, with
  ``allreduce.bn_stats`` inside the norm layers' spans;
* ``profile_step`` files what NTS-Net's ``_nms`` and ``_crop`` launch under
  the model's own spans, and nothing else under the step's.
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

import hawkeye_tpu_torch.models  # noqa: F401  (registry side effects)
from hawkeye_tpu_torch.models import init_parameters
from hawkeye_tpu_torch.models.backbones.norm import BatchNorm
from hawkeye_tpu_torch.models.methods.ntsnet import NTSNet
from hawkeye_tpu_torch.profile_step import _launch_category
from hawkeye_tpu_torch.utils import trace
from torch_trace_worker import QuietTrainer, parents, tiny_config

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = [torch.profiler.ProfilerActivity.CPU]
STEPS = 2  # synthetic length 8, batch 4
HOST = ("data.wait", "data.collate", "pin", "forward", "backward")


def _trainer(tmp_path, name):
    # one decode thread: the loader's pool path, whose wait is on futures
    return QuietTrainer(tiny_config(tmp_path, name, workers=1), device="cpu")


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _refuse(*args, **kwargs):
    raise AssertionError("the tracer hooked or ranged where it may not")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two steps with no profiler (the tracer's tools made to raise, the
    norm layers' inputs kept) and the same two steps of a twin trainer with
    one recording."""
    tmp = tmp_path_factory.mktemp("trace")
    off = _trainer(tmp, "off")
    inputs = []
    for m in off.model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_pre_hook(lambda mod, args: inputs.append(args[0]))
    trace.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", _refuse)
        mp.setattr(torch.Tensor, "register_hook", _refuse)
        off.train_epoch(0.01)
    off_summary = trace.summary()

    on = _trainer(tmp, "on")
    with pytest.MonkeyPatch.context() as mp, torch.profiler.profile(activities=CPU) as prof:
        mp.setattr(torch.Tensor, "register_hook", _refuse)
        trace.reset()
        on.train_epoch(0.01)
    n_bn = sum(isinstance(m, BatchNorm) for m in on.model.modules())
    events = prof.events()
    yield {"off": off, "off_summary": off_summary, "inputs": inputs, "on": on,
           "summary": trace.summary(events), "events": events, "n_bn": n_bn}
    trace.reset()


def test_off_records_and_registers_nothing(runs):
    assert runs["off_summary"] == {"steps": 0, "spans": {}, "counters": {}}
    assert len(runs["inputs"]) == STEPS * runs["n_bn"]
    assert all(x._backward_hooks is None for x in runs["inputs"])
    assert trace.span("forward") is trace.span("batch_norm")  # one shared no-op


def test_profiler_on_trains_bitwise_as_off(runs):
    off, on = _state(runs["off"]), _state(runs["on"])
    assert off.keys() == on.keys()
    assert all(torch.equal(off[k], on[k]) for k in off)


def test_spans_a_step_and_their_nesting(runs):
    s, n_bn = runs["summary"], runs["n_bn"]
    assert n_bn == 20  # ResNet-18: the stem, two a block, three downsamples
    assert s["steps"] == STEPS and s["counters"] == {}
    calls = {name: row["calls"] for name, row in s["spans"].items()}
    assert calls == {**{n: STEPS for n in HOST}, "batch_norm": STEPS * n_bn,
                     "batch_norm.backward": STEPS * n_bn}
    for row in s["spans"].values():  # no CUDA: host times only
        assert row["device_ms"] is None and row["host_ms"] > 0
    events = runs["events"]
    assert parents(events) == {("batch_norm", "forward"), ("batch_norm.backward", "backward"),
                               *((n, None) for n in HOST)}
    forwards = sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.name == trace.PREFIX + "forward")
    norms = [e.time_range.start for e in events if e.name == trace.PREFIX + "batch_norm"]
    assert [sum(a <= t <= b for t in norms) for a, b in forwards] == [n_bn] * STEPS
    line = trace.describe(s)
    assert line.startswith(f"spans a step over {STEPS} traced steps: ")
    assert f"batch_norm {n_bn}/step, host " in line


def _event(name, start, end, kernels=(), device=False, annotation=False, thread=1, seq=-1,
           fwd_thread=0, scope=0):
    dt = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        kernels=[SimpleNamespace(duration=us) for us in kernels],
        device_type=dt.CUDA if device else dt.CPU, is_user_annotation=annotation,
        thread=thread, sequence_nr=seq, fwd_thread=fwd_thread, scope=scope)


def test_summary_gives_each_span_the_work_launched_inside_it():
    """Made-up events, times in microseconds as the profiler gives them.
    The main thread's ``backward`` and the autograd thread's nodes share the
    launches made while they were open; ``batch_norm.backward`` is the node
    of the last op inside ``batch_norm`` with the node's number (``pow``
    makes no node and shares ``relu``'s, whose op ran outside; the node's
    own record carries the number too, on the CPU on the same thread); a launch's
    runtime call and the device's own copy of a range count for nothing."""
    evaluate = trace.EVALUATE
    events = [
        _event("hk::forward", 0, 100),
        _event("hk::batch_norm", 10, 40),
        _event("aten::native_batch_norm", 12, 14, kernels=(2,), seq=5),
        _event("aten::pow", 20, 21, seq=6),
        _event("hk::allreduce.bn_stats", 25, 35),
        _event("c10d::allreduce_", 26, 28, kernels=(4,)),
        _event("aten::relu", 50, 51, kernels=(1,), seq=6),
        _event("hk::backward", 200, 400),  # main thread, waiting on autograd's
        _event(evaluate + "ReluBackward0", 210, 220, thread=2, seq=6, fwd_thread=1),
        _event("aten::threshold_backward", 211, 212, kernels=(3,), thread=2),
        _event(evaluate + "NativeBatchNormBackward0", 230, 260, thread=2, seq=5,
               fwd_thread=1),
        _event("NativeBatchNormBackward0", 231, 259, thread=1, seq=5, scope=1),
        _event("aten::native_batch_norm_backward", 231, 232, kernels=(7,), thread=2),
        _event("cudaLaunchKernel", 231, 232, kernels=(100,), thread=2),
        _event(evaluate + "torch::autograd::AccumulateGrad", 270, 275, thread=2),
        _event("aten::add_", 271, 272, kernels=(8,), thread=2),
        _event("aten::sum", 500, 501, kernels=(9,)),  # under no span
        _event("hk::forward", 0, 100, device=True, annotation=True),
        _event("void kernel", 300, 301, device=True),
    ]
    with torch.profiler.profile(activities=CPU):
        trace.reset()
        trace.span("batch_norm", backward=True)  # a span with a backward
    s = trace.summary(events)
    got = {n: (r["calls"], round(r["host_ms"] * 1e3), round(r["device_ms"] * 1e3))
           for n, r in s["spans"].items()}
    assert got == {"forward": (1, 100, 7), "batch_norm": (1, 30, 6),
                   "allreduce.bn_stats": (1, 10, 4), "backward": (1, 200, 18),
                   "batch_norm.backward": (1, 30, 7)}
    cpu = torch.autograd.DeviceType.CPU
    host_only = trace.summary([e for e in events if e.device_type == cpu])
    assert all(r["device_ms"] is None for r in host_only["spans"].values())
    trace.reset()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_ranks_count_their_collectives(tmp_path):
    port, world = _free_port(), 2
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    env.pop("PYTEST_XDIST_WORKER", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_trace_worker.py"),
                               str(r), str(world), str(port), str(tmp_path), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    for r in range(world):
        with open(tmp_path / f"rank{r}.json") as f:
            got = json.load(f)
        steps, widths = got["summary"]["steps"], got["bn_widths"]
        assert steps == 2 and got["rows"] == [4, 4] and len(widths) == 20
        # a step: each norm layer's statistics [sum, sum of squares, count]
        # forward and their gradient backward (float32), then the gradients
        # in one float32 buffer
        stats = sum(2 * (2 * c + 1) * 4 for c in widths)
        assert got["summary"]["counters"] == {
            "collective.calls": steps * (2 * len(widths) + 1),
            "collective.bytes": steps * (stats + 4 * got["params"])}
        calls = {k: v["calls"] for k, v in got["summary"]["spans"].items()}
        assert calls["allreduce.bn_stats"] == 2 * steps * len(widths)
        assert calls["allreduce.grads"] == steps
        parents = {tuple(x) for x in got["parents"]}
        assert {p for n, p in parents if n == "allreduce.bn_stats"} == {
            "batch_norm", "batch_norm.backward"}
        assert ("allreduce.grads", None) in parents


def test_profile_step_reads_the_region_spans_of_the_model():
    """NTS-Net's ``_nms`` and ``_crop`` are the spans ``nms`` and
    ``roi_crop``: ``profile_step`` files the ops launched under them in
    those categories, and no other op of the step's ``forward`` span."""
    m = NTSNet(num_classes=5, proposal_num=4, cat_num=3, image_size=64, pad_side=64,
               part_size=64, backbone_name="resnet18", dtype=torch.float32)
    init_parameters(m, torch.Generator().manual_seed(0))
    m.train()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.profiler.profile(activities=CPU) as prof:
        with trace.span("forward"):
            m(x, generator=torch.Generator().manual_seed(2))
    counts = {}
    for e in prof.events():
        if e.name.startswith("aten::"):
            c = _launch_category(e)
            counts[c] = counts.get(c, 0) + 1
    assert set(counts) == {None, "nms", "roi_crop"}
    assert counts["nms"] > 0 and counts["roi_crop"] > 0
    trace.reset()
