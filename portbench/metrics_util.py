"""Arithmetic that several per-layer readers share."""

from . import peaks


def roofline(run, kernels):
    """Percent of the roofline of the kernels named (substrings of kernel
    names, keys of the reference's ``KERNEL_WORK``) over the traced steps:
    the sum of bounds over the sum of measured times. None where a kernel
    has no count from shapes, did not run, or ran another number of times
    than its count says."""
    s = run.summary
    if s is None:
        return None
    bound = measured = 0.0
    for name in kernels:
        work = run.kernel_work.get(name)
        if work is None:
            return None
        nbytes, flops, launches = work(run.cell.per_rank, run.cell.config["run"]["dataset"]
                                       ["transformer"]["image_size"])
        seconds, count = s.kernel_time(name)
        if count == 0 or count != launches * s.steps:
            return None
        bound += peaks.bound_s(nbytes, flops) * s.steps
        measured += seconds
    return 100.0 * bound / measured
