"""A trainer for the tests only: the Baseline ResNet-50 with two parameter
groups by name prefix (``backbone`` at 0.1x the rate, ``fc`` at 1x), built
by the port's own ``prefix_param_groups`` as the zoo's Examples build
theirs."""

from __future__ import annotations

from hawkeye_tpu_torch.engine.optim import prefix_param_groups
from hawkeye_tpu_torch.examples.Baseline import BaselineTrainer

LR_MULT = {"backbone": 0.1, "fc": 1.0}


class GroupedBaselineTrainer(BaselineTrainer):
    def get_param_groups(self):
        return prefix_param_groups(self.model, {k: k for k in LR_MULT}, LR_MULT)
