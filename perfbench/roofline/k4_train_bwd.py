"""Kernel 4, the BiLSTM training backward (``csrc/bilstm_train_bwd.cu``):
three launches a step, at the shapes of ``lstm_work.shapes``."""

import re

from perfbench.roofline import lstm_work

PATTERN = re.compile(r"bwd_kernel")


def launches(step: dict, model: dict) -> list:
    h = model["module_dim"] // 2
    return [lstm_work.train_backward(t, r, h, steps, masked, outs) for t, r, steps, masked, outs in
            lstm_work.shapes(step, model)]
