"""Data parallelism across processes: the process group and its collectives.

Counterpart of ``hawkeye_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a 1-D device mesh: the batch is sharded over the ``data``
axis, the parameters are replicated, XLA adds the gradient all-reduce, and
BatchNorm's statistics span the whole sharded batch. Its single-process
mesh over several devices has no one-process counterpart here: the port runs
one process per GPU (``torchrun --nproc_per_node=N``), each on
``cuda:LOCAL_RANK`` with its slice of every global batch
(``parallel/multihost.py``), and joins them with these collectives:

* ``init_from_env``: the process group from ``torchrun``'s environment
  (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), NCCL on CUDA
  and gloo on the CPU, with a timeout; a caller may set one up itself (two
  ranks on one GPU need gloo, since NCCL refuses them), and the Trainer then
  takes it as it is;
* ``broadcast_module``: rank 0's parameters and buffers to every rank;
* ``average_gradients``: every gradient averaged over the ranks in one
  coalesced all-reduce, after the backward and before the update, as DDP
  does. The Trainer calls it rather than wrapping the model in
  ``DistributedDataParallel``: the Example trainers call the model more
  than once per step (MGE-CNN's experts, S3N's views, Peer-Learning's two
  peers), call its submodules directly, and leave some parameters without a
  gradient in some steps, all of which DDP's reducer refuses or needs
  ``find_unused_parameters`` for; the mean of the per-rank gradients is the
  same either way;
* ``all_reduce_sum``: the one all-reduce (a sum) that every collective of
  a step goes through: the gradient average, BatchNorm's statistics, metric
  sums; while a profiler records it counts its calls and bytes
  (``utils/trace.py``: ``collective.calls``, ``collective.bytes``).

Global-batch BatchNorm is ``models/backbones/norm.py``'s ``cross_replica``
(an in-place all-reduce of the statistics each way), which the Trainer
switches on in a world of more than one process.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..utils import trace

TIMEOUT = datetime.timedelta(minutes=10)


def world():
    """(rank, world size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_rank():
    return int(os.environ.get("LOCAL_RANK", 0))


def init_from_env(device_type="cuda", timeout=TIMEOUT):
    """Join the process group that ``torchrun`` describes in the
    environment; a no-op for one process or where a group exists. Returns
    (rank, world size)."""
    size = int(os.environ.get("WORLD_SIZE", 1))
    if size > 1 and not dist.is_initialized():
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ["MASTER_PORT"]
        dist.init_process_group(
            "nccl" if device_type == "cuda" else "gloo",
            init_method=f"tcp://{addr}:{port}", world_size=size,
            rank=int(os.environ["RANK"]), timeout=timeout)
    return world()


@torch.no_grad()
def broadcast_module(module, src=0):
    """Every parameter and buffer of ``module`` from rank ``src``."""
    if world()[1] > 1:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)


@torch.no_grad()
def average_gradients(params):
    """Each gradient replaced by its mean over the ranks, one all-reduce
    per dtype (the gradients flattened into one buffer), under the span
    ``allreduce.grads``."""
    size = world()[1]
    if size == 1:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault((p.grad.dtype, p.grad.device), []).append(p.grad)
    for grads in by_dtype.values():
        with trace.span("allreduce.grads"):
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
            flat.div_(size)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()


def all_reduce_sum(t):
    """``t`` summed over the ranks (in place; returned)."""
    if world()[1] > 1:
        if trace.enabled():
            trace.count("collective.calls")
            trace.count("collective.bytes", t.numel() * t.element_size())
        dist.all_reduce(t)
    return t
