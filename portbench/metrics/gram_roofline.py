"""Share of its roofline that the ported ``gram_signed_sqrt`` kernel reaches
in the traced steps: bound (bf16 X read, float32 Gram written, 2 HW C^2
operations an image) over measured time."""

from portbench.metrics_util import roofline

UNIT = "%"
BETTER = "higher"
LAYER = "ported ops and kernels: ops/pool.py, ops/fused_bilinear.py, csrc/*.cu"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    return roofline(run, ("gram_signed_sqrt",))
