"""One rank of the two-process cross-replica BatchNorm that
test_torch_batch_norm_xr.py compares with one process.

    python tests/torch_bn_xr_worker.py RANK WORLD PORT OUT

Joins a gloo process group at ``tcp://127.0.0.1:PORT`` and, for each case
of ``CASES``, draws the whole batch from the case's seed (as the test
does), normalises its half of the rows with a float64 ``BatchNorm`` whose
statistics span the ranks, and runs the backward of ``sum(y * dy)`` with
its half of ``dy``. Writes y, the batch statistics (from the running
averages' first fold), dx, dweight and dbias of each case to
``OUT/rank<RANK>.pt``. Imports no JAX."""

import datetime
import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hawkeye_tpu_torch.models.backbones.norm import BatchNorm  # noqa: E402

# name: (whole batch's shape, channels-last, seed)
CASES = {"nchw": ((8, 6, 5, 3), True, 11), "rows": ((10, 7), False, 12)}


def case_tensors(shape, channels_last, seed):
    """The whole batch's x, dy, weight and bias of one case, float64."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen, dtype=torch.float64) * 2 + 0.5
    dy = torch.randn(shape, generator=gen, dtype=torch.float64)
    c = shape[1]
    weight = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    bias = torch.randn(c, generator=gen, dtype=torch.float64)
    if channels_last:
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    return x, dy, weight, bias


def main(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = {}
        for name, (shape, channels_last, seed) in CASES.items():
            x, dy, weight, bias = case_tensors(shape, channels_last, seed)
            per = shape[0] // world
            x, dy = (t[rank * per:(rank + 1) * per] for t in (x, dy))
            bn = BatchNorm(shape[1], cross_replica=True).double()
            with torch.no_grad():
                bn.weight.copy_(weight)
                bn.bias.copy_(bias)
            x = x.detach().requires_grad_(True)
            y = bn(x)
            (y * dy).sum().backward()
            got[name] = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
                         "dbias": bn.bias.grad, "running_mean": bn.running_mean,
                         "running_var": bn.running_var}
        torch.save(got, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, p = (int(a) for a in sys.argv[1:4])
    main(r, w, p, sys.argv[4])
