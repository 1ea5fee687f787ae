"""Share of their roofline that the ported pool kernels reach in the traced
steps: the sum over the step's launches of each one's bound (the larger of
bytes over 3.35 TB/s and operations over 989 TFLOP/s, bytes from the five
pool shapes: each input byte read once, each output byte written once),
over the sum of their measured times. Nothing is read where the launches
per step are not what the shapes say."""

from portbench.metrics_util import roofline

UNIT = "%"
BETTER = "higher"
LAYER = "ported ops and kernels: ops/pool.py, ops/fused_bilinear.py, csrc/*.cu"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    return roofline(run, ("pool_fwd_kernel", "pool_bwd_kernel"))
