from .optim import (build_optimizer, build_scheduler, prefix_param_groups,
                    set_learning_rate)
from .tester import Tester
from .trainer import Trainer, emergency_save

__all__ = [
    "Tester",
    "Trainer",
    "emergency_save",
    "build_optimizer",
    "build_scheduler",
    "prefix_param_groups",
    "set_learning_rate",
]
