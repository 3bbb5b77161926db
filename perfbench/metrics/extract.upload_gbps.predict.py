"""extract.upload_gbps.predict: the decoded frames' bytes the port put on
the card in the traced window (``extract.upload_bytes``) over the host
seconds of its ``extract.upload`` spans, in GB/s. None where the program
has neither."""

def read(trace):
    program = trace.counters.get("program", {})
    nbytes = program.get("counters", {}).get("extract.upload_bytes")
    seconds = sum(program.get("spans", {}).get("extract.upload", []))
    if not nbytes or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
