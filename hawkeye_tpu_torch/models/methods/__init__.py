from . import baseline, bcnn  # noqa: F401  (MODEL registrations)
