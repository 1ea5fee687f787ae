"""The numbers that decide ``correct`` in a training cell.

The program's first steps (taken through the window's own ``train_epoch``
on distinct rows of the pool, by the object that the window then drives)
against the reference's from the same seed and rows:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first step's
  gradient (the program's worked out from its optimizer's state);
* ``change_gap``: the worst leaf's gap between the norms of the
  parameters' change over the checked steps;
* ``grad_gap_median``, ``change_gap_median``: the median leaf's gaps.

A cell compares the numbers that its ``limits`` name.

A leaf's gap is ``| |a| - |r| |`` over the larger of the reference's norm
of that leaf and of the median leaf. Leaves whose reference gradient is
under a thousandth of the median leaf's (nought to rounding) are left out
of the change, since round-off alone moves them.
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
NOUGHT = 1e-3


def leaf_gaps(prog, ref, keys):
    """{leaf: gap} over ``keys``."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}


def leaves(prog, ref):
    """Per-leaf gaps of the first gradient and of the change."""
    keys = sorted(ref["grad_norms"])
    if sorted(prog["grad_norms"]) != keys or len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the program and the reference have different leaves or steps")
    med = statistics.median(ref["grad_norms"][k] for k in keys)
    moving = [k for k in keys if ref["grad_norms"][k] >= NOUGHT * med]
    return (leaf_gaps(prog["grad_norms"], ref["grad_norms"], keys),
            leaf_gaps(prog["change_norms"], ref["change_norms"], moving))


def readings(prog, ref):
    """Every number a cell may compare: the worst leaf's gaps, and the
    median leaf's (``*_median``)."""
    grad, change = leaves(prog, ref)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": statistics.median(grad.values()),
        "change_gap_median": statistics.median(change.values()),
    }


def judge(values, limits):
    """(correct, [(name, value, limit)]) over the numbers that ``limits``
    names (all of ``NUMBERS`` where it names none): every one finite and at
    or under its limit; a number without a limit fails."""
    names = [k for k in values if k in limits] or list(NUMBERS)
    rows = [(k, values[k], limits.get(k)) for k in names]
    ok = all(lim is not None and math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
