"""Share of the traced stretch in which no device activity runs on any
stream (the union of the kernels', copies' and sets' intervals), averaged
over the cards of the run."""

UNIT = "%"
BETTER = "lower"
LAYER = "device"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
