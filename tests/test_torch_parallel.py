"""The port's multi-process data parallelism (hawkeye_tpu_torch/parallel/,
the Trainer's sharding, gradient average, metric sums and global-batch
BatchNorm) against the JAX package's.

* The logic cases of test_multihost.py on the port's copies: the process
  shards partition each global batch, agree across processes on an epoch's
  order, and pad a val tail with weight-0 rows that decode to real indices;
  two Trainers configured as processes 0 and 1 of 2 in one process cover
  each val sample once; DCL's collates keep the pad weights.
* Two processes (gloo on the CPU, spawned with a free port and a 60 s
  limit) run one train step of a float64 ``TINY`` ResNet classifier
  (``torch_ddp_worker.F64Net``: the Baseline's ``pool`` and head are
  float32 in both packages) at a global batch of 8, 4 rows each, from the
  same weights; the JAX Trainer
  runs the step on the conftest's 8-device CPU mesh, whose BatchNorm spans
  the sharded global batch. Every parameter's update and every running
  statistic within 1e-10 of the tensor's largest value, the mean of the
  ranks' losses within 1e-12 of JAX's, the two ranks' models identical, and
  global-batch BatchNorm on in both ranks. A single process at the same
  global batch gives the same step (the sharding changes nothing).
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import socket
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.engine import Trainer as JaxTrainer
from hawkeye_tpu.registry import BACKBONE as JAX_BACKBONE
from hawkeye_tpu_torch.config import ConfigNode, setup_config
from hawkeye_tpu_torch.data.dcl import DCLBackboneCollate, DCLTrainCollate, DCLValCollate
from hawkeye_tpu_torch.data.sampler import RandomBatchSampler, SequentialBatchSampler
from hawkeye_tpu_torch.engine import Trainer
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.parallel import PaddingAwareDataset, ProcessShardedBatchSampler
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_trainer import _tiny_recipe_path
from torch_ddp_worker import PortF64Trainer

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-10
LR = float(np.float32(0.05))  # the JAX step takes its rate in float32


# ----------------------------------------------------------------------------
# the logic cases of test_multihost.py
# ----------------------------------------------------------------------------
def test_process_shards_partition_the_batch_and_agree_on_the_epoch():
    inner = RandomBatchSampler(64, batch_size=16, seed=0)
    shards = [list(ProcessShardedBatchSampler(inner, process_index=i, process_count=4))
              for i in range(4)]
    inner.set_epoch(0)
    for b, batch in enumerate(list(inner)):
        np.testing.assert_array_equal(np.concatenate([shards[i][b] for i in range(4)]),
                                      batch)
        assert all(len(shards[i][b]) == 4 for i in range(4))
    sa = ProcessShardedBatchSampler(RandomBatchSampler(32, batch_size=8, seed=1), 0, 2)
    sb = ProcessShardedBatchSampler(RandomBatchSampler(32, batch_size=8, seed=1), 1, 2)
    sa.set_epoch(3)
    sb.set_epoch(3)
    for x, y in zip(sa, sb):
        assert set(x.tolist()).isdisjoint(y.tolist())
    # without a process group: rank 0 of 1
    solo = ProcessShardedBatchSampler(inner)
    assert (solo.process_index, solo.process_count) == (0, 1)


def test_val_tail_padded_not_truncated():
    inner = SequentialBatchSampler(10, batch_size=4, drop_last=False)  # tail of 2
    shards = [list(ProcessShardedBatchSampler(inner, process_index=i, process_count=4))
              for i in range(4)]
    seen = [s for b in range(len(shards[0])) for i in range(4) for s in shards[i][b].tolist()]
    assert sorted(s for s in seen if s >= 0) == list(range(10))
    assert all(0 <= ((-1 - s) if s < 0 else s) < 10 for s in seen)

    class _DS:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return {"label": np.int64(i)}

    ds = PaddingAwareDataset(_DS())
    assert ds[3]["weight"] == 1.0 and ds[3]["label"] == 3
    assert ds[-1 - 3]["weight"] == 0.0 and ds[-1 - 3]["label"] == 3


def test_trainer_simulated_two_processes(tmp_path):
    """Two Trainers configured as processes 0 and 1 of 2 in one process
    together cover every val sample once (synthetic val: 5 samples, one
    global batch of 5 padded to 6, 3 rows each, one of weight 0)."""
    def cfg(i):
        return ConfigNode({
            "experiment": {"name": f"mh{i}", "log_dir": str(tmp_path), "seed": 0,
                           "debug": True},
            "dataset": {"name": "synthetic", "length": 20, "batch_size": 8,
                        "num_workers": 0, "num_processes": 2, "process_index": i,
                        "transformer": {"image_size": 32, "resize_size": 36}},
            "model": {"name": "ResNet18", "num_classes": 4, "dtype": "float32"},
            "train": {"epoch": 1, "optimizer": {"name": "SGD", "lr": 0.01},
                      "scheduler": {"name": "CosineAnnealingLR", "T_max": 1},
                      "criterion": {"name": "CrossEntropyLoss"}},
        }).freeze()

    trainers = [Trainer(cfg(i), device="cpu") for i in range(2)]
    counts = []
    for t in trainers:
        assert t.world_size == 1 and isinstance(t.dataloaders["val"].dataset,
                                                PaddingAwareDataset)
        counts.append(sum(float(b["weight"].sum()) for b in t.dataloaders["val"]))
        assert [len(b["label"]) for b in t.dataloaders["train"]] == [4, 4]
    assert sorted(counts) == [2.0, 3.0]
    assert "acc" in trainers[0].validate()


def test_dcl_collates_preserve_padding_weights():
    items = [{"img": np.zeros((56, 56, 3), np.uint8), "label": 1, "weight": np.float32(1.0)},
             {"img": np.zeros((56, 56, 3), np.uint8), "label": 1, "weight": np.float32(0.0)}]
    np.testing.assert_array_equal(DCLTrainCollate(grid=7)(items)["weight"], [1, 0, 1, 0])
    for collate in (DCLValCollate(grid=7), DCLBackboneCollate()):
        np.testing.assert_array_equal(collate(items)["weight"], [1, 0])
    plain = [{"img": np.zeros((56, 56, 3), np.uint8), "label": 0}]
    np.testing.assert_array_equal(DCLValCollate(grid=7)(plain)["weight"], [1])


# ----------------------------------------------------------------------------
# two processes against the JAX Trainer on the 8-device mesh
# ----------------------------------------------------------------------------
class JaxF64Net(fnn.Module):
    """``torch_ddp_worker.F64Net`` in flax: the ``TINY`` trunk and a linear
    head on the mean of its ``c5``, in float64."""

    @fnn.compact
    def __call__(self, x, train=False):
        c5 = JAX_BACKBONE.get(TINY)(dtype=jnp.float64, name="backbone")(x, train=train)["c5"]
        return {"logits": fnn.Dense(4, dtype=jnp.float64, param_dtype=jnp.float64,
                                    name="fc")(c5.mean(axis=(1, 2)))}


class JaxF64Trainer(JaxTrainer):
    def get_model(self, model_config):
        return JaxF64Net()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(world, config, init, batch, out, timeout=60):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    env.pop("PYTEST_XDIST_WORKER", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_ddp_worker.py"),
                               str(r), str(world), str(port), config, init, batch, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]


@pytest.mark.usefixtures("tiny_trunk")
def test_two_process_step_matches_jax_global_batch_step(tmp_path):
    path = _tiny_recipe_path("Baseline.yaml", tmp_path, {
        "dataset": {"length": 16, "batch_size": 8,
                    "transformer": {"image_size": 32, "resize_size": 36}},
        "model": {"num_classes": 4},
        # no label smoothing: the JAX package's smoothed target is float32
        "train": {"optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9,
                                "weight_decay": 1e-4},
                  "criterion": {"name": "CrossEntropyLoss", "label_smoothing": 0.0}}})
    pt = PortF64Trainer(setup_config(argv=["--config", path]), device="cpu")
    # the float32 values the bridge hands to JAX, in every process
    load_jax_variables(pt.model, export_jax_variables(pt.model))
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    init = str(tmp_path / "init.pt")
    torch.save(before, init)
    rs = np.random.RandomState(0)
    batch = {"img": rs.randn(8, 32, 32, 3), "label": rs.randint(0, 4, 8).astype(np.int64)}
    np.savez(tmp_path / "batch.npz", **batch)
    ranks = _run_ranks(2, path, init, str(tmp_path / "batch.npz"), str(tmp_path))

    with jax.enable_x64(True):
        # the JAX trainer's variables in float64 too: float32 statistics
        # would fold 0.9 * s in float32
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 export_jax_variables(pt.model))
        jt = type("JaxF64Init", (JaxF64Trainer,), {
            "init_model_variables": lambda self: variables})(
                jax_setup_config(argv=["--config", path]))
        assert jt.mesh.devices.size == 8
        jt.state, mj = jt.train_step_call(jt.prepare_batch(batch, train=True),
                                          jnp.asarray(LR, jnp.float32))
        want = jax.device_get({"params": jt.state.params,
                               "batch_stats": jt.state.batch_stats})
        jax_before = export_jax_variables(pt.model)
    # one process at the same global batch: the same step
    mp = pt.train_step_call(pt.prepare_batch(batch, train=True), LR)

    for r, got in enumerate(ranks):
        assert got["world"] == (r, 2) and got["cross_replica"]
        for k, v in got["state"].items():
            assert torch.equal(v, ranks[0]["state"][k]), k
    loss = np.mean([g["metrics"]["loss"] for g in ranks])
    np.testing.assert_allclose(loss, float(mj["loss"]), rtol=1e-6)  # JAX: float32
    np.testing.assert_allclose(float(mp["loss"]), loss, rtol=1e-12)
    assert sum(g["metrics"]["correct"] for g in ranks) == float(mj["correct"])

    for state in (ranks[0]["state"], pt.model.state_dict()):
        pt.model.load_state_dict(state)
        got = _tree64(pt.model)
        flat_g, flat_w, flat_b = (
            {jax.tree_util.keystr(k): np.asarray(v, np.float64)
             for k, v in jax.tree_util.tree_leaves_with_path(t)}
            for t in (got, want, jax_before))
        assert flat_g.keys() == flat_w.keys()
        for k, w in flat_w.items():
            if "batch_stats" in k:
                scale = np.abs(w).max()
            else:  # the update: new - old
                w = w - flat_b[k]
                flat_g[k] = flat_g[k] - flat_b[k]
                scale = np.abs(w).max()
            np.testing.assert_allclose(flat_g[k], w, rtol=0, atol=TOL * scale, err_msg=k)


def _tree64(module):
    """Parameters and statistics in the flax layout, in float64."""
    from hawkeye_tpu_torch.models import bridge

    tree = {}
    for (col, path), (_, t) in bridge._name_map(module).items():
        node = tree.setdefault(col, {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = bridge._to_jax_layout(t.detach().double().numpy(), path[-1])
    return tree
