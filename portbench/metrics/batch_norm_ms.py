"""Device ms per traced step of the kernels named ``batch_norm`` (the
native train-mode path of ``norm.py``). The cross-replica path launches
plain elementwise and sum kernels that this name cannot see."""

UNIT = "ms"
BETTER = "lower"
LAYER = "normalisation: models/backbones/norm.py"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    return s.ms_per_step("batch_norm") if s and s.categories.get("batch_norm") else None
