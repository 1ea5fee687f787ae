"""Device ms per traced step of the kernels launched under
``Optimizer.step`` (foreach SGD with momentum, or Adam)."""

UNIT = "ms"
BETTER = "lower"
LAYER = "optimizer: engine/optim.py"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    return s.ms_per_step("optimizer") if s and s.categories.get("optimizer") else None
