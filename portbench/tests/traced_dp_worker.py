"""One rank of a traced CPU run of a cell on several processes (gloo), for
the tests: ``python -m portbench.tests.traced_dp_worker <folder> <cell>
<seed>`` with the process-group environment set; rank 0 prints the result
line last."""

from __future__ import annotations

import json
import sys
import time

import torch

from portbench import catalog, cell, probe
from portbench.tests.tiny import patched_instrument


def main(root, name, seed):
    probe.instrument = patched_instrument()
    result = cell.run_rank(catalog.load_cell(name, root), int(seed), 0.2, True,
                           torch.device("cpu"), time.perf_counter())
    if result is not None:
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
