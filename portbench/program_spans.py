"""Readings of the port's own tracer (``hawkeye_tpu_torch/utils/trace.py``)
over a run's traced stretch, for the per-layer readers of its spans and
counters.

The tracer's spans are ``hk::`` ranges among the traced stretch's profiler
events, and ``trace.summary`` reads them from there; the tracer records
counters and ``Trainer.train_step_call`` counts steps while a profiler
records, which in a run is the traced stretch alone. The record that a
reader gets does not carry the profiler: the harness's frame that calls the
readers (``cell._run_rank``) holds the stretch's ``trace.Profile`` in its
local ``profile``, and the summary of its events is kept on it.

Each reading is a total over the stretch divided by its steps, and is None
where the program has no tracer (an older checkout of the port), where
the run has no traced stretch, where the tracer's step count is not the
trace's (what it counted is not that stretch), or where the span or counter
never ran; a device reading is None without CUDA as well.
"""

from __future__ import annotations

import sys

import torch

from .trace import Profile


def _stretch_profile():
    """The traced stretch's ``Profile``, from the frames above, or None."""
    f = sys._getframe(1)
    while f is not None:
        p = f.f_locals.get("profile")
        if isinstance(p, tuple) and p and isinstance(p[-1], Profile):
            return p[-1] if p[-1].prof is not None else None
        f = f.f_back
    return None


def _traced(run):
    if run.summary is None:
        return None
    try:
        from hawkeye_tpu_torch.utils import trace
    except ImportError:  # a port without its own tracer
        return None
    prof = _stretch_profile()
    if prof is None:
        return None
    s = getattr(prof, "program_spans", None)
    if s is None:
        s = prof.program_spans = trace.summary(prof.prof.events())
    return s if s["steps"] == run.summary.steps > 0 else None


def host_ms(run, name):
    """Host ms a traced step inside the span ``name``."""
    s = _traced(run)
    row = s and s["spans"].get(name)
    return row["host_ms"] / s["steps"] if row else None


def device_ms(run, *names):
    """Device ms a traced step of the work launched inside the spans
    ``names`` (summed; each has to have run)."""
    if not torch.cuda.is_available():
        return None
    s = _traced(run)
    rows = [s and s["spans"].get(n) for n in names]
    if not all(r and r["device_ms"] is not None for r in rows):
        return None
    return sum(r["device_ms"] for r in rows) / s["steps"]


def per_step(run, counter):
    """The counter ``counter`` a traced step."""
    s = _traced(run)
    n = s and s["counters"].get(counter)
    return n / s["steps"] if n else None
