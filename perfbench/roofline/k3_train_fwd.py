"""Kernel 3, the BiLSTM training forward that keeps the pre-step states (``csrc/bilstm_train_fwd.cu``):
three launches a step, at the shapes of ``lstm_work.shapes``."""

import re

from perfbench.roofline import lstm_work

PATTERN = re.compile(r"recurrence_kernel<[^>]*true>")


def launches(step: dict, model: dict) -> list:
    h = model["module_dim"] // 2
    return [lstm_work.train_forward(t, r, h, steps, masked, outs) for t, r, steps, masked, outs in
            lstm_work.shapes(step, model)]
