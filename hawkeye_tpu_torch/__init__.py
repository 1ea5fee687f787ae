"""Hawkeye on PyTorch and CUDA: the port of ``hawkeye_tpu`` to one NVIDIA H100.

Same config schema, registries, trainer lifecycle and checkpoint semantics as
the JAX package, which stays the reference. Plain tensor code is PyTorch; the
TPU's Pallas kernels are hand-written CUDA kernels for Hopper (``csrc/``),
built at first use by ``ops/_build.py``. This package imports no JAX.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import ConfigNode, build_config_from_dict, setup_config
from .registry import BACKBONE, LOSS, MODEL, Repository

__all__ = [
    "ConfigNode",
    "build_config_from_dict",
    "setup_config",
    "Repository",
    "MODEL",
    "BACKBONE",
    "LOSS",
]
