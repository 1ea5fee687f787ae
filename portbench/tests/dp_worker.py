"""One rank of a CPU run of a cell on several processes (gloo), for the
tests: ``python -m portbench.tests.dp_worker <folder> <cell> <seed>
[<fault>]`` with the process-group environment set; rank 0 prints the
result line last. The fault ``jax_on_rank_1`` puts a module named ``jax``
into rank 1's ``sys.modules``."""

from __future__ import annotations

import json
import os
import sys
import time
import types

import torch

from portbench import catalog, cell, probe
from portbench.tests.tiny import patched_instrument


def main(root, name, seed, fault=None):
    if fault == "jax_on_rank_1":  # JAX loaded on one rank only
        fault = None
        if os.environ["RANK"] == "1":
            sys.modules["jax"] = types.ModuleType("jax")
    probe.instrument = patched_instrument(fault)
    result = cell.run_rank(catalog.load_cell(name, root), int(seed), 0.2, False,
                           torch.device("cpu"), time.perf_counter())
    if result is not None:
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
