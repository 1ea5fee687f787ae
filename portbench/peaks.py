"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the denominators of the rooflines
and of ``train_mfu``."""

BF16_FLOPS = 989e12  # dense bf16/fp16 tensor-core FLOP/s
HBM_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(nbytes, flops):
    """The least time the chip could take: the larger of the byte and the
    operation bounds."""
    return max(nbytes / HBM_BYTES, flops / BF16_FLOPS)
