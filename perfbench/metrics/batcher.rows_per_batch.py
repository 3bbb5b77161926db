"""batcher.rows_per_batch: the requests a batch of the ``BatchingEngine``
carried in the traced window, from the engine's own counts
(``EngineStats``) at the window's ends."""

def read(trace):
    start, stop = trace.counters.get("start"), trace.counters.get("stop")
    if not start or not stop or stop["batches"] <= start["batches"]:
        return None
    return (stop["requests"] - start["requests"]) / (stop["batches"] - start["batches"])
