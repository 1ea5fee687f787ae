"""Megabytes (1e6 bytes) all-reduced a traced step on rank 0: the program's
counter ``collective.bytes`` (``parallel/mesh.py`` ``all_reduce_sum``) over
1e6. Exact: the float32 gradients and, per BatchNorm layer of C channels,
2 x (2C + 1) float32 statistics."""

from portbench.program_spans import per_step

UNIT = "MB"
BETTER = "lower"
LAYER = "data parallel: parallel/mesh.py, models/backbones/norm.py _AllReduceSum"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    n = per_step(run, "collective.bytes")
    return None if n is None else n / 1e6
