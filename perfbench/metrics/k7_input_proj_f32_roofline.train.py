"""k7_input_proj_f32_roofline.train: the share of its roofline that kernel 7, the appearance BiLSTM's fp32
input projection, reached over the traced window
(``lib/roofline.py``), in percent."""

from perfbench.lib.roofline import share
from perfbench.roofline import k7_input_proj_f32


def read(trace):
    return share(trace, k7_input_proj_f32)
