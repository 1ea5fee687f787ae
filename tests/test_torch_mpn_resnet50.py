"""The port's MPN on ResNet-50 with the recipe's reduction to 256 against
the JAX package's, one train-mode step from bridged weights, the trunk in
float64 on both sides; the tolerances of test_torch_mpn.py."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
from test_torch_mpn import mpn_step


def test_mpn_resnet50_float64_train_step_matches_jax():
    pm = mpn_step("resnet50")
    assert pm.fc.in_features == 256 * 257 // 2
    assert pm.dr_conv.weight.shape == (256, 2048, 1, 1)
