"""Device ms per traced step of the pointwise and reduction kernels outside
the augmentation and the optimizer: the trunks' bias adds and ReLUs, the
heads, the loss and their backward."""

UNIT = "ms"
BETTER = "lower"
LAYER = "model trunk, head and loss: models/methods/{bcnn,baseline}.py, losses"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    if s is None:
        return None
    ms = s.ms_per_step("elementwise/other") + s.ms_per_step("reduction")
    return ms if ms > 0 else None
