from ._build import LAUNCHES, reset_launches
from .bilinear import bilinear_pool
from .fused_bilinear import bilinear_pool_fused, gram_signed_sqrt
from .pool import relu_maxpool2x2

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "bilinear_pool",
    "bilinear_pool_fused",
    "gram_signed_sqrt",
    "relu_maxpool2x2",
]
