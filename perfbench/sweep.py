"""Finds the highest request rate the serving cell sustains: one set-up,
then the cell's traffic at each rate of a list, each for a few seconds.

    python3 perfbench/sweep.py --workload msrvtt-qa.serve --rates 600,800,1000 --seconds 6

A rate is sustained when the requests complete at the rate offered and
the last fifth of them waits no longer than the first fifth, within the
noise: the backlog does not grow. One JSON line a rate, with the garbage
collector's pauses in it (a full collection of a process that has imported
torch stalls it for a few hundred ms). The benchmark's
own runs do not run this; the cell's rate is a number in its file.
"""

import argparse
import gc
import json
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.drivers.serve import _Served, percentile  # noqa: E402
from perfbench.lib import common  # noqa: E402
from perfbench.lib.harness import Context  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", default="msrvtt-qa.serve")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    workload = common.workload(args.workload)
    config = common.config(workload["config"])
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        ctx = Context(args.workload, workload, config, args.seed, args.seconds, False, device, tmp)
        served = _Served(ctx)
        pauses = []
        started = {}

        def on_gc(phase, info):
            if phase == "start":
                started["t"] = time.perf_counter()
            elif "t" in started:
                pauses.append((info["generation"], time.perf_counter() - started.pop("t")))

        gc.callbacks.append(on_gc)
        try:
            served.drive(workload["rate"], workload["warmup_seconds"], args.seed)
            for i, rate in enumerate(float(r) for r in args.rates.split(",")):
                t0 = time.perf_counter()
                pauses.clear()
                _, lat, _, late = served.drive(rate, args.seconds, args.seed + i + 1)
                took = time.perf_counter() - t0
                done = [x for x in lat.tolist() if math.isfinite(x)]
                fifth = max(1, len(lat) // 5)
                head, tail = lat[:fifth].tolist(), lat[-fifth:].tolist()
                print(json.dumps({
                    "rate": rate, "requests": len(lat), "failed": len(lat) - len(done),
                    "completed_per_s": len(done) / took, "p50_ms": percentile(lat, 0.5) * 1e3,
                    "p95_ms": percentile(lat, 0.95) * 1e3, "p99_ms": percentile(lat, 0.99) * 1e3,
                    "first_fifth_p50_ms": percentile(head, 0.5) * 1e3,
                    "last_fifth_p50_ms": percentile(tail, 0.5) * 1e3,
                    "mean_batch": served.engine.stats()["mean_batch"],
                    "issued_late_max_ms": float(late.max()) * 1e3,
                    "issued_late_p99_ms": percentile(late, 0.99) * 1e3,
                    "gc_pauses": len(pauses), "gc_pause_max_ms": max((d for _, d in pauses), default=0) * 1e3,
                    "gc_pause_total_ms": sum(d for _, d in pauses) * 1e3,
                    "gc_full": sum(1 for g, _ in pauses if g == 2),
                }), flush=True)
        finally:
            served.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
