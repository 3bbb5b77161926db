"""extract.mfu.predict: the backbones' conv FLOPs in the traced window
(ResNet-101's a frame times the port's ``extract.frames``, the 3D
ResNeXt-101's a clip times its ``extract.clips``) over the window's
seconds on the host's clock and the card's fp32 peak
(``lib/peaks.py``: 3xTF32, 165 TFLOP/s), in percent. None where the
program counts no extraction."""

from perfbench.lib.backbone_flops import video_flops
from perfbench.lib.peaks import PEAK_FLOPS


def read(trace):
    counters = trace.counters.get("program", {}).get("counters", {})
    if "extract.frames" not in counters or "extract.clips" not in counters or trace.host_window_s <= 0:
        return None
    flops = video_flops(trace.config, counters["extract.frames"], counters["extract.clips"])
    return 100.0 * flops / trace.host_window_s / PEAK_FLOPS["float32"]
