"""Device ms per traced step of the kernels launched under the benchmark's
range around ``Trainer.device_augment`` (crop-resize, flip, TrivialAugmentWide,
normalisation, erasing)."""

UNIT = "ms"
BETTER = "lower"
LAYER = "device augmentation: data/transforms_device.py, data/ta_wide_device.py, ops/resample.py"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    return s.ms_per_step("augmentation") if s and s.categories.get("augmentation") else None
