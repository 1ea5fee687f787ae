"""Device ms a traced step of the gradient average: the work launched in the
program's span ``allreduce.grads`` (``parallel/mesh.py`` ``average_gradients``:
the flatten, the one all-reduce with the wait for the peers, the copy back),
read from the profiler's events."""

from portbench.program_spans import device_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "data parallel: parallel/mesh.py, models/backbones/norm.py _AllReduceSum"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return device_ms(run, "allreduce.grads")
