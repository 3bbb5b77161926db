"""train.mfu: the model FLOPs of the traced window's train steps (the
forward, the weight gradients and the input gradients the port takes, a
question; ``lib/model_flops.py::train_flops``) over the window's seconds on
the host's clock and the card's fp32 peak (``lib/peaks.py``: 3xTF32, 165
TFLOP/s), in percent. The host's clock, because the profiler's can put the
window's edges a tenth of a second off."""

from perfbench.lib.model_flops import dims_of, train_flops
from perfbench.lib.peaks import PEAK_FLOPS


def read(trace):
    if not trace.steps or trace.host_window_s <= 0:
        return None
    flops = train_flops(**dims_of(trace.config)) * sum(s["valid"] for s in trace.steps)
    return 100.0 * flops / trace.host_window_s / PEAK_FLOPS["float32"]
