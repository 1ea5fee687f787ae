"""One intra-op thread for PyTorch in each of pytest-xdist's workers.

The tier-1 run puts the tests in six worker processes, each with JAX's
thread pool besides. PyTorch's default of one OpenMP thread per core in
every worker oversubscribes the cores many times over, and its spinning
threads then cost the run several times its work: twelve of the heaviest
port files took 3544 s of test time under six workers with the default and
596 s with one thread each (an 8-core host). A single pytest process keeps
the default, which runs a file alone 3-4 s faster where its models are
ResNet-50-sized. Every port test file imports this module first."""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
