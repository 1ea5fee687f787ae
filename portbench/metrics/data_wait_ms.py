"""Mean host time per window step spent in the loader iterator's
``__next__``: the wait for the next collated batch (the port's thread
``DataLoader`` and ``default_collate``)."""

UNIT = "ms"
BETTER = "lower"
LAYER = "host data: data/loader.py, default_collate"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return run.spans.mean_ms("data_wait", run.steps)
