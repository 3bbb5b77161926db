"""train_step.ms: mean device time of one ``train_lib.train_step`` call in the
traced window, from CUDA events around it."""

def read(trace):
    ms = trace.timings.get("train_step", [])
    return sum(ms) / len(ms) if ms else None
