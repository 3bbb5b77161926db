"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit) and the roofline bound of a piece of work."""

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 outside the tensor cores (TF32 off)
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
