"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit) and the roofline bound of a piece of work.

One fp32 peak: the card's fastest fp32-accurate matmul rate, which is
3xTF32 on the tensor cores (each product as three TF32 products, big x
big + big x small + small x big, summed in fp32), 495 / 3 TFLOP/s. Every
fp32 product of the program may run at that rate with at least fp32's
accuracy: kernels 7 and 8 do, at 0.35-0.38x the library SGEMMs' error
against fp64. A lower precision is a different result (TF32 convs fail
the predict cell's ``logit_rel_gap`` by 20x). So an fp32 share reads the
same work against the same rate whatever implements it, on the CUDA
cores (at most 67 TFLOP/s, so at most 41% of this peak) or on the tensor
cores, and no fp32 kernel that does the work it is counted for reads
over 100%.
"""

PEAK_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
PEAK_FLOPS = {"float32": PEAK_TF32_FLOPS / 3, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12  # HBM3


def bound_s(flops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)
