"""eval_forward.ms: mean device time of one ``train_lib.pred_step`` call in the
traced window, from CUDA events around it."""

def read(trace):
    ms = trace.timings.get("pred_step", [])
    return sum(ms) / len(ms) if ms else None
