"""Host ms a traced step in ``Trainer.prepare_batch``'s copies: each host
array wrapped, pinned and its copy to the card enqueued. The program's
span ``pin`` (``hawkeye_tpu_torch/engine/trainer.py``)."""

from portbench.program_spans import host_ms

UNIT = "ms"
BETTER = "lower"
LAYER = "trainer loop: engine/trainer.py prepare_batch, train_step_call"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    return host_ms(run, "pin")
