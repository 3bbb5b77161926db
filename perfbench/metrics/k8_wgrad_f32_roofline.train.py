"""k8_wgrad_f32_roofline.train: the share of its roofline that kernel 8, the appearance BiLSTM's fp32
weight gradient dW_ih, reached over the traced window
(``lib/roofline.py``), in percent."""

from perfbench.lib.roofline import share
from perfbench.roofline import k8_wgrad_f32


def read(trace):
    return share(trace, k8_wgrad_f32)
