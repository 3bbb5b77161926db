"""serve_forward.mfu: the forward FLOPs of the served batches' real rows over
the predict fn's device time and the card's fp32 peak
(``lib/peaks.py``: 3xTF32, 165 TFLOP/s), in percent."""

from perfbench.lib.model_flops import dims_of, forward_flops
from perfbench.lib.peaks import PEAK_FLOPS


def read(trace):
    ms = trace.timings.get("predict", [])
    if not trace.steps or not ms:
        return None
    flops = forward_flops(**dims_of(trace.config)) * sum(s["valid"] for s in trace.steps)
    return 100.0 * flops / (sum(ms) / 1e3) / PEAK_FLOPS["float32"]
