"""``step_ms_p95`` in a cell whose steps the host paces: the 95th
percentile of the interval between consecutive step-end CUDA events, over
the window's steps outside the traced stretch (the profiler slows the steps
it covers). There it swings with the host's load from run to run (over
twelve runs of one call: ResNet-50 b128 171-274 ms, four cards at 64 a rank
259-312 ms), too widely for a bound, so it stands as a per-layer reading
beside the rate it moves."""

import statistics

UNIT = "ms"
BETTER = "lower"
LAYER = "trainer loop: engine/trainer.py prepare_batch, train_step_call"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    if len(run.step_ms) < 2:
        return None
    return statistics.quantiles(run.step_ms, n=20)[18]
