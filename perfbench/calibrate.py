"""Readings that the limits of a cell are set from: the numbers that decide
``correct``, for the program, its control and planted faults, over many
seeds in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 --variant program
    python3 perfbench/calibrate.py --workload <cell> --seeds 4,5,6 --variant control
    python3 perfbench/calibrate.py --workload <cell> --seeds 7,8,9 --variant fault:half

``program`` is the program as the configuration states it; ``control`` the
program in the precision below it (its bf16 streaming); ``fault:<name>``
the program with a fault planted under the timed path
(``lib/harness.py``). Each seed runs the cell's set-up and checked work
(training needs no window; the other cells run a short one at the cell's
own load), then the comparison, with no limit applied. One JSON line a
seed on standard output. The benchmark's own runs do not run this.
"""

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench.lib import common  # noqa: E402
from perfbench.lib.harness import Context, free  # noqa: E402
from perfbench.lib.runner import run_cell  # noqa: E402


def readings(cell: str, seed: int, variant: str, device) -> dict:
    workload = common.workload(cell)
    workload["limits"] = {k: math.inf for k in workload["limits"]}
    workload["warmup_steps"] = 0
    config = common.config(workload["config"])
    faults = (variant.split(":", 1)[1],) if variant.startswith("fault:") else ()
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        ctx = Context(cell, workload, config, seed, 0.0, False, device, tmp,
                      variant="control" if variant == "control" else None, faults=faults, readings_only=True)
        t0 = time.perf_counter()
        res = run_cell(ctx)
    free(device)
    return {"cell": cell, "seed": seed, "variant": variant, "seconds": round(time.perf_counter() - t0, 3),
            "readings": ctx.readings, "log": ctx.log}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--variant", default="program")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.variant, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
