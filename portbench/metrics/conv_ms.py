"""Device ms per traced step of the cuDNN convolution kernels (by kernel
name), outside the augmentation."""

UNIT = "ms"
BETTER = "lower"
LAYER = "library under the trunks: cuDNN convs of models/backbones/{vgg,resnet}.py"
MOVES = "train_images_per_sec"
SOURCE = "device_trace"


def read(run):
    s = run.summary
    return s.ms_per_step("convolution") if s and s.categories.get("convolution") else None
