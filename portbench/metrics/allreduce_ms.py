"""Device ms per traced step of the NCCL kernels on rank 0: the gradient
average of ``parallel/mesh.py`` and the BatchNorm statistics' all-reduces
of ``norm.py``, forward and backward."""

UNIT = "ms"
BETTER = "lower"
LAYER = "data parallel: parallel/mesh.py, models/backbones/norm.py _AllReduceSum"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    return s.ms_per_step("collective") if s and s.categories.get("collective") else None
