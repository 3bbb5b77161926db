"""predict_call.ms: mean device time of one ``predict_frames`` call in the
traced window (a video and its questions: upload, resize, both backbones,
DualVGR), from CUDA events around it."""

def read(trace):
    ms = trace.timings.get("predict_frames", [])
    return sum(ms) / len(ms) if ms else None
