"""The reference trains as the recipe does, driven through the harness at
the tiny size on the CPU: the scheduled rate at the window's epoch (a
linear warm-up from 0.01x here), the recipe's groups' rate multipliers
(``backbone`` 0.1x, ``fc`` 1x) and the model's own per-step draws.

A tiny cell added as files to the test's copy of the benchmark runs the
ResNet-50 configuration with the warm-up, a trainer with the groups
(``grouped_trainer.py``) and a copy of the ResNet-50 reference that
declares the same groups. A sound run is correct under the limits of the
tiny ResNet-50 cell; the program without its groups, the program without
its warm-up, and the reference without its multipliers (the harness before
it followed the groups) are each not correct. The reference's generator
for the model's draws draws what the program's ``model_generator`` does,
on every rank's slice; its scheduled rate is the port's for every recipe
in ``configs/``."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch
import yaml

from portbench import catalog, cell, probe
from portbench.reference import common
from portbench.tests import grouped_trainer, tiny
from portbench.tests.test_portbench_check import LIMITS

GROUPED = "grouped_resnet50.train_b128"
SEED = 2**32 + 2**31 + 977  # above 32 bits
# the recipes that train (``configs/test.yaml`` only evaluates)
RECIPES = [p for p in sorted((catalog.HERE.parent / "configs").glob("*.yaml"))
           if "optimizer" in (yaml.safe_load(p.read_text()).get("train") or {})]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.tiny_bench(tmp_path_factory.mktemp("bench"))
    cfg = yaml.safe_load((r / "configs" / "baseline_resnet50_448.yaml").read_text())
    cfg.update(name="grouped_resnet50", reference="grouped_resnet50",
               trainer="portbench.tests.grouped_trainer:GroupedBaselineTrainer")
    cfg["run"]["train"]["scheduler"].update(warmup_epochs=10, lr_warmup_decay=0.01)
    (r / "configs" / "grouped_resnet50.yaml").write_text(yaml.safe_dump(cfg))
    src = (r / "reference" / "baseline_resnet50_448.py").read_text()
    (r / "reference" / "grouped_resnet50.py").write_text(
        f"{src}\n\nLR_MULT = {grouped_trainer.LR_MULT!r}\n")
    (r / "workloads" / f"{GROUPED}.json").write_text(json.dumps(
        {"config": "grouped_resnet50", "traffic": "train_b128", "chips": 1,
         "why": "two rate groups and a warm-up", "limits": LIMITS}))
    return r


def _drop_warmup(trainer):
    """The program at the recipe's cosine with its warm-up left out."""
    from hawkeye_tpu_torch.engine.optim import build_scheduler

    sched = {k: v for k, v in trainer.config.train.scheduler.items()
             if k not in ("warmup_epochs", "lr_warmup_decay")}
    trainer.scheduler = build_scheduler(sched, float(trainer.config.train.optimizer.lr))


def _float64(trainer):
    """The port in float64, as the float64 agreement test puts it: in
    float32 ResNet-50's first gradients alone differ by 1e-2 at this size."""
    tiny.float32_port(trainer)
    for m in trainer.model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    trainer.model.double()
    trainer.model.fc.register_forward_pre_hook(lambda m, a: (a[0].double(),))


def _run(root, monkeypatch, fault=None):
    instrument = probe.instrument

    def float64(trainer, spans):
        if fault == "program_without_warmup":
            _drop_warmup(trainer)
        _float64(trainer)
        return instrument(trainer, spans)

    monkeypatch.setattr(probe, "instrument", float64)
    augment, init = common.augment, common.lecun_init
    monkeypatch.setattr(common, "augment", lambda *a: augment(*a).double())
    monkeypatch.setattr(common, "lecun_init", lambda m, g: init(m, g).double())
    if fault == "program_without_groups":
        from hawkeye_tpu_torch.examples.Baseline import BaselineTrainer

        monkeypatch.setattr(catalog, "trainer_class", lambda c: BaselineTrainer)
    elif fault == "reference_without_multipliers":
        load = catalog.reference_module

        def ungrouped(c):
            ref = load(c)
            del ref.LR_MULT
            return ref

        monkeypatch.setattr(catalog, "reference_module", ungrouped)
    elif fault not in (None, "program_without_warmup"):
        raise ValueError(fault)
    lines = []
    result = cell.run_rank(catalog.load_cell(GROUPED, root), SEED, 0.2, False,
                           torch.device("cpu"), time.perf_counter(),
                           log=lambda line, **k: lines.append(json.loads(line)))
    return result, lines[-1]


def test_sound_grouped_warmup_run_is_correct(root, monkeypatch):
    result, info = _run(root, monkeypatch)
    assert result["correct"], result["checks"]
    # the info line tells the two sides' rates and the groups apart
    assert info["program_lr"] == info["reference_lr"] == pytest.approx(1e-6)
    assert info["reference_leaves_at"] == {"0.1": 159, "1.0": 2}


@pytest.mark.parametrize("fault", ["program_without_groups", "program_without_warmup",
                                   "reference_without_multipliers"])
def test_fault_is_not_correct(root, monkeypatch, fault):
    result, _ = _run(root, monkeypatch, fault)
    assert not result["correct"], (fault, result["checks"])


def test_model_generator_is_the_programs_on_every_rank(root, tmp_path):
    """The generator that the reference hands its module at steps 0-2
    draws what ``Trainer.model_generator()`` draws at those steps, and so
    does each rank's slice's generator, two ranks of two rows each."""
    c = catalog.load_cell(GROUPED, root)
    run = cell.Run(c, SEED, torch.device("cpu"), log_dir=tmp_path)
    seen = []

    class Recorder:
        build = staticmethod(run.ref.build)

        @staticmethod
        def loss_and_backward(model, imgs, labels, precision, generator=None, per_rank=None):
            seen.append((generator, per_rank, imgs.shape[0]))
            return run.ref.loss_and_backward(model, imgs, labels, precision)

    rows = np.arange(c.pool_images).reshape(-1, c.global_batch)[:1].repeat(3, 0)
    common.reference_steps(Recorder, run.cfg, run.images, run.labels, rows, run.seed,
                           c.per_rank // 2, run.device)
    assert [s[1:] for s in seen] == [(c.per_rank // 2, c.global_batch)] * 3
    trainer = run.trainer
    for step, (gen, per_rank, n) in enumerate(seen):
        trainer.step = step
        want = torch.rand(5, generator=trainer.model_generator())
        slices = common.rank_generators(gen, n, per_rank)
        assert len(slices) == 2
        for g in [gen, *slices]:
            assert torch.equal(torch.rand(5, generator=g), want), step
    run.free()


@pytest.mark.parametrize("recipe", RECIPES, ids=lambda p: p.stem)
def test_epoch_rate_is_the_ports(recipe):
    from hawkeye_tpu_torch.config import ConfigNode
    from hawkeye_tpu_torch.engine.optim import build_scheduler

    cfg = yaml.safe_load(recipe.read_text())
    train = ConfigNode(cfg).train
    port = build_scheduler(train.get("scheduler"), float(train.optimizer.lr))
    for epoch in (0, 1, 4, 9, 10, 11, 30, 59):
        assert common.epoch_rate(cfg, epoch) == port.epoch_lr(epoch), (recipe.name, epoch)


def test_multipliers_match_by_whole_name_prefix():
    class Ref:
        LR_MULT = {"backbone": 0.1, "backbone.layer1": 3.0, "fc": 1.0}
        LR_MULT_DEFAULT = 0.5

    names = ["backbone.conv1.weight", "backbone.layer1.w", "backbone2.w", "fc.bias", "fc"]
    assert common.rate_multipliers(Ref, names) == {
        "backbone.conv1.weight": 0.1, "backbone.layer1.w": 0.1, "backbone2.w": 0.5,
        "fc.bias": 1.0, "fc": 1.0}
    assert set(common.rate_multipliers(object(), names).values()) == {1.0}
