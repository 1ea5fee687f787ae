"""All-reduces a traced step on rank 0: the program's counter
``collective.calls`` (``parallel/mesh.py`` ``all_reduce_sum``, which every
all-reduce of a step goes through). Exact: ResNet-50's 53 BatchNorm layers
forward and backward, and the gradient's one."""

from portbench.program_spans import per_step

UNIT = "calls"
BETTER = "lower"
LAYER = "data parallel: parallel/mesh.py, models/backbones/norm.py _AllReduceSum"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return per_step(run, "collective.calls")
