"""device.idle_share.predict: the share of the traced window in which no
operation ran on the card, from the profiler's trace, in percent."""

def read(trace):
    if trace.busy_s is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
