"""Host ms a traced step that the loader's main thread spends getting a
batch's items, waiting on the decode threads' futures: the program's span
``data.wait`` (``hawkeye_tpu_torch/data/loader.py``)."""

from portbench.program_spans import host_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "host data: data/loader.py, default_collate"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return host_ms(run, "data.wait")
