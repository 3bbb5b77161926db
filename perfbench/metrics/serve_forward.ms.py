"""serve_forward.ms: mean device time of one call of the serving program's
predict fn (forward, softmax, top-k and their fetch) in the traced window,
from CUDA events around it."""

def read(trace):
    ms = trace.timings.get("predict", [])
    return sum(ms) / len(ms) if ms else None
