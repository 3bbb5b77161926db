"""loader.wait_ms.train: mean host seconds, in ms, that a step of the traced
window waited for its batch from the prefetched loader (the harness's
``loader.wait`` span around each ``next()``)."""

def read(trace):
    waits = trace.spans.get("loader.wait", [])
    return 1e3 * sum(waits) / len(waits) if waits else None
