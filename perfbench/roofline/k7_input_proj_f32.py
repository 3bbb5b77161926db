"""Kernel 7, the appearance BiLSTM's fp32 input projection of both
directions (``csrc/input_proj_f32.cu``): one launch a train step or an
eval forward, its W split pass (``tf32_split_kernel``) in the same entry.
Per launch on R = rows x clips sequences of T frames, D = vision_dim
wide, 4H = 2 x module_dim gates a direction: one fp32 product, 2 R T D x
2 4H flops, which the kernel runs as three TF32 products; the bytes as
the program's ``chip_smoke.py::phase_proj_f32`` counts them: x, W_hi and
W_lo, the biases, both directions' gates written. Kernel 8 works on the
same shapes (``dims``, ``flops``)."""

import re

PATTERN = re.compile(r"\b(input_proj_f32_kernel|tf32_split_kernel)\b")


def dims(step: dict, model: dict) -> tuple[int, int, int, int]:
    """(R, T, D, 4H) of the appearance projection of one step."""
    return step["rows"] * model["num_of_nodes"], model["frames_per_clip"], model["vision_dim"], 2 * model["module_dim"]


def flops(r: int, t: int, d: int, g: int) -> float:
    """One fp32 product over both directions: (R T, D) @ (D, 2 4H)."""
    return 2.0 * r * t * d * 2 * g


def launch(r: int, t: int, d: int, g: int) -> tuple[float, float]:
    return flops(r, t, d, g), 4 * (r * t * d + 2 * (2 * g * d) + 2 * g + 2 * t * r * g)


def launches(step: dict, model: dict) -> list:
    return [launch(*dims(step, model))]
