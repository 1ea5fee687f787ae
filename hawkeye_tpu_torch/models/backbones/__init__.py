from . import resnet, vgg  # noqa: F401  (BACKBONE registrations)
