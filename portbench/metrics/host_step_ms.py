"""Mean host time per window step inside ``Trainer.prepare_batch`` (pinned
host-to-device copy) and ``Trainer.train_step_call`` (the launches of the
augmentation, forward, backward and update). Where the device sets the
pace, this is mostly back-pressure from the full launch queue."""

UNIT = "ms"
BETTER = "lower"
LAYER = "trainer loop: engine/trainer.py prepare_batch, train_step_call"
MOVES = "train_images_per_sec"
SOURCE = "program_span"


def read(run):
    parts = [run.spans.mean_ms(n, run.steps) for n in ("prepare_batch", "train_step_call")]
    return None if None in parts else sum(parts)
