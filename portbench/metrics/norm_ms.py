"""Device ms a traced step of every train-mode normalisation: the work
launched in the program's spans ``batch_norm`` (``models/backbones/norm.py``
``batch_norm_train``, without the running-statistics fold) and
``batch_norm.backward`` (from the first op of a layer's backward to its
input's gradient), read from the profiler's events; inclusive, so on several
cards the statistics' all-reduces with their waits for the peers too."""

from portbench.program_spans import device_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "normalisation: models/backbones/norm.py"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return device_ms(run, "batch_norm", "batch_norm.backward")
