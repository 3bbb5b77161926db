"""k2_gat_cycle_roofline.eval: the share of its roofline that kernel 2, the fused graph cycle,
reached over the traced window (``lib/roofline.py``), in percent."""

from perfbench.lib.roofline import share
from perfbench.roofline import k2_gat_cycle


def read(trace):
    return share(trace, k2_gat_cycle)
