from .logging_utils import TqdmHandler, get_logger
from .meters import AverageMeter, PerformanceMeter, Timer, accuracy
from .rng import resolve_device, set_random_seed
from .tensors import device_constant

__all__ = [
    "AverageMeter",
    "PerformanceMeter",
    "Timer",
    "accuracy",
    "device_constant",
    "TqdmHandler",
    "get_logger",
    "resolve_device",
    "set_random_seed",
]
