"""loader.wait_ms.eval: mean host time, in ms, between the end of one call of
the evaluation function and the start of the next within a pass: the
fetch of the predictions, the loader's next batch and the copy."""

def read(trace):
    gaps = trace.spans.get("eval.between", [])
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
