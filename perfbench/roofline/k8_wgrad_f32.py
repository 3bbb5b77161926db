"""Kernel 8, the appearance BiLSTM's fp32 weight gradient dW_ih of both
directions (``csrc/wgrad_f32.cu``): one launch a train step, its x split
pass (``x_split_kernel``) in the same entry. Kernel 7's shapes and
product (``k7_input_proj_f32.dims``, ``.flops``), which the kernel runs
as three TF32 products; the bytes as the program's
``chip_smoke.py::phase_wgrad_f32`` counts them: x and both directions'
dgates read, dW written."""

import re

from perfbench.roofline.k7_input_proj_f32 import dims, flops

PATTERN = re.compile(r"\b(wgrad_f32_kernel|x_split_kernel)\b")


def launch(r: int, t: int, d: int, g: int) -> tuple[float, float]:
    return flops(r, t, d, g), 4 * (r * t * d + 2 * t * r * g + 2 * g * d)


def launches(step: dict, model: dict) -> list:
    return [launch(*dims(step, model))]
