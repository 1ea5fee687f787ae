"""Device ms a traced step of the work launched in ``loss.backward()`` (on
the autograd engine's thread too): the program's span ``backward``
(``Trainer.train_step_call``), read from the profiler's events."""

from portbench.program_spans import device_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "model trunk, head and loss: models/methods/{bcnn,baseline}.py, losses"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return device_ms(run, "backward")
