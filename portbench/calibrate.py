"""The readings that the limits of ``correct`` are set from, at a cell's own
size on its own cards.

    python -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--controls 3]

For each seed, in one process per card: the program's checked steps as a
run takes them (set-up, then ``train_epoch`` over the first distinct rows),
against the float32 reference: the sound runs' ``loss_gap``, ``grad_gap``
and ``change_gap`` (the lower readings). For the first ``--controls``
seeds, also the reference put in the program's place:

* ``control``: computed in float8 (e4m3 values, e5m2 gradients, per-tensor
  scaled) in every conv, linear and Gram product, the precision below the
  configuration's bfloat16 trunk;
* ``half_batch``: half of each global batch left out, the mean over the
  rest;
* ``label_altered``: the first row of each step's global batch trained on
  the next class (its label altered where the batch is made);
* ``no_exchange`` (cells on several cards): rank 0's rows alone, with its
  own batch statistics, as a rank whose gradient and statistics
  all-reduces were left out.

A step that returns its state unchanged reads 1 on ``change_gap`` by the
measure itself and needs no run. One JSON line per seed on rank 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from . import catalog, check


def altered_labels(run, batches):
    """The pool's labels with the first row of each batch moved to the next
    class (the checked steps' rows are distinct)."""
    labels = run.labels.copy()
    classes = int(run.cfg["model"]["num_classes"])
    for rows in batches:
        labels[rows[0]] = (labels[rows[0]] + 1) % classes
    return labels


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from . import cell as cell_run, launch

    cell = catalog.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("portbench.calibrate: not enough CUDA devices", file=sys.stderr)
        return 2
    ranks = None
    if cell.chips > 1 and "RANK" not in os.environ:
        ranks = launch.Ranks(__spec__.name, argv, cell.chips)
        os.environ.update(ranks.env0)
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    seeds = [int(s) for s in args.seeds.split(",")]
    try:
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="portbench-") as log_dir:
                run = cell_run.Run(cell, seed, device, log_dir=log_dir)
                program, batches = run.checked_steps()
                run.free()
            rank = dist.get_rank() if dist.is_initialized() else 0
            if rank == 0:
                line = {"seed": seed, "program_s": time.perf_counter() - t0}
                ref = cell_run.reference_readings(run, batches)
                line["sound"] = check.readings(program, ref)
                grad, change = check.leaves(program, ref)
                line["worst"] = {"grad": sorted(grad, key=grad.get)[-3:],
                                 "change": sorted(change, key=change.get)[-3:]}
                line["losses"] = {"program": program["losses"], "reference": ref["losses"]}
                if i < args.controls:
                    faults = {"control": {"precision": "fp8"},
                              "half_batch": {"keep_rows": cell.global_batch // 2}}
                    if cell.chips > 1:
                        faults["no_exchange"] = {"keep_rows": cell.per_rank}
                    faults["label_altered"] = {"labels": altered_labels(run, batches)}
                    for name, kw in faults.items():
                        line[name] = check.readings(
                            cell_run.reference_readings(run, batches, **kw), ref)
                line["seconds"] = time.perf_counter() - t0
                print(json.dumps(line), flush=True)
            del run
            if dist.is_initialized():
                dist.barrier()
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        if ranks:
            ranks.kill()
        raise
    if ranks and any(ranks.wait()):
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
