"""Device ms a traced step of the cross-replica BatchNorm's all-reduces of
the statistics, forward and backward: the work launched in the program's
span ``allreduce.bn_stats`` (``models/backbones/norm.py`` ``_AllReduceSum``:
the clone and the collective, whose kernel holds the wait for the peers),
read from the profiler's events."""

from portbench.program_spans import device_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "data parallel: parallel/mesh.py, models/backbones/norm.py _AllReduceSum"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return device_ms(run, "allreduce.bn_stats")
