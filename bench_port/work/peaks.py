"""One NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense, at
the 700 W power limit): float32 outside the tensor cores, bfloat16 on
them, and HBM3 bandwidth."""

FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES = 3.35e12


def least_seconds(fp32_ops: float = 0.0, bytes_moved: float = 0.0,
                  bf16_flops: float = 0.0) -> float:
    """The least time the work needs on the card: the larger of its
    operations at their peaks and its bytes at the memory rate."""
    return max(fp32_ops / FP32_FLOPS + bf16_flops / BF16_FLOPS, bytes_moved / HBM_BYTES)


def op_seconds(fp32_ops: float = 0.0, bf16_flops: float = 0.0) -> float:
    """The time the work's operations alone take at the peaks."""
    return fp32_ops / FP32_FLOPS + bf16_flops / BF16_FLOPS
