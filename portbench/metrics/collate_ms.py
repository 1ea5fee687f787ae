"""Host ms a traced step in the loader's ``collate_fn`` on the main thread
(``default_collate``, which stacks the batch's decodes): the program's span
``data.collate`` (``hawkeye_tpu_torch/data/loader.py``)."""

from portbench.program_spans import host_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "host data: data/loader.py, default_collate"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return host_ms(run, "data.collate")
