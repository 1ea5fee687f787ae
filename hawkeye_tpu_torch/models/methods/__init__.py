from . import bcnn  # noqa: F401  (MODEL registrations)
