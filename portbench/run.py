"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the cards of this machine: the cell's ``chips`` of them, one
process each (this one is rank 0 and starts the others). Exits non-zero
and prints no result without CUDA or with fewer cards than the cell asks
for, and when JAX or the JAX package is loaded once the window has closed.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; then ``checks``, each number that decided ``correct`` with
its limit, which are also the last lines of standard error. An earlier
JSON line gives the set-up time, the peak device memory, the step count,
the card and its power limit, and the process's CPU seconds in the window.

The CUDA driver's cache of kernels built from PTX stays inside the
checkout, at ``.portbench_cache/nv`` (the port's own kernel build is in
``hawkeye_tpu_torch/_build/``), so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CUDA_CACHE = CHECKOUT / ".portbench_cache" / "nv"
HANG_S = 345  # a run that has not ended by then dumps its stacks and exits


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    os.environ["CUDA_CACHE_PATH"] = str(CUDA_CACHE)
    faulthandler.dump_traceback_later(HANG_S, exit=True)

    import torch

    from . import catalog, cell as cell_run, launch

    cell = catalog.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    ranks = None
    if cell.chips > 1 and "RANK" not in os.environ:
        ranks = launch.Ranks(__spec__.name, argv, cell.chips)
        os.environ.update(ranks.env0)
    local = int(os.environ.get("LOCAL_RANK", 0))
    try:
        result = cell_run.run_rank(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda", local), T_START)
    except cell_run.ForbiddenModules as e:
        print(f"portbench: {e}", file=sys.stderr)
        if ranks:
            ranks.kill()
        return 4
    except BaseException:
        if ranks:
            ranks.kill()
        raise
    if ranks:
        codes = ranks.wait()
        if any(codes):
            print(f"portbench: ranks 1-{len(codes)} exited with {codes}", file=sys.stderr)
            return 3
    if result is not None:
        for name, c in result["checks"].items():
            print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
