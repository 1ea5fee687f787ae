from . import vgg  # noqa: F401  (BACKBONE registrations)
