"""The whole step's share of the cards' dense bf16 peak: model FLOPs per
trained image (the reference module's count from shapes: convs, linears and
the Gram, forward x 3, less the first conv's input gradient; no
recomputation, augmentation or optimizer) times the images per second of
the window's steps outside the traced stretch (global batch over the step
clock's intervals, which the profiler does not slow), over 989 TFLOP/s
times the cards."""

from portbench import peaks

UNIT = "%"
BETTER = "higher"
LAYER = "whole step"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    if not run.step_ms:
        return None
    rate = run.cell.global_batch * len(run.step_ms) / (sum(run.step_ms) / 1e3)
    return 100.0 * run.flops_per_image * rate / (peaks.BF16_FLOPS * run.chips)
