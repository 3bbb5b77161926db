"""k3_train_fwd_roofline.train: the share of its roofline that kernel 3, the BiLSTM training forward,
reached over the traced window (``lib/roofline.py``), in percent."""

from perfbench.lib.roofline import share
from perfbench.roofline import k3_train_fwd


def read(trace):
    return share(trace, k3_train_fwd)
