"""k1_recurrence_roofline.eval: the share of its roofline that kernel 1, the BiLSTM recurrence,
reached over the traced window (``lib/roofline.py``), in percent."""

from perfbench.lib.roofline import share
from perfbench.roofline import k1_recurrence


def read(trace):
    return share(trace, k1_recurrence)
