"""Kernel 1, the BiLSTM recurrence of the eval forward (``csrc/bilstm_recurrence.cu``):
three launches a step, at the shapes of ``lstm_work.shapes``."""

import re

from perfbench.roofline import lstm_work

PATTERN = re.compile(r"recurrence_kernel<[^>]*false>")


def launches(step: dict, model: dict) -> list:
    h = model["module_dim"] // 2
    return [lstm_work.recurrence(t, r, h, steps, masked, outs) for t, r, steps, masked, outs in
            lstm_work.shapes(step, model)]
