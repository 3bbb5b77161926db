"""k4_train_bwd_roofline.train: the share of its roofline that kernel 4, the BiLSTM training backward,
reached over the traced window (``lib/roofline.py``), in percent."""

from perfbench.lib.roofline import share
from perfbench.roofline import k4_train_bwd


def read(trace):
    return share(trace, k4_train_bwd)
