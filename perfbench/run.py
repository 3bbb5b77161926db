"""Runs one cell of the benchmark once and prints its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's file ``perfbench/workloads/<cell>.json``
names its configuration and its driver; ``BENCHMARK.json`` lists the
metrics. The last line of standard output is the result's JSON object.
Exits 2 without the CUDA cards the cell asks for, and 3 if JAX or the JAX
package was loaded.
"""

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


PROCESS_START = _process_start()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

if __name__ == "__main__":
    from perfbench.lib.runner import main

    sys.exit(main(sys.argv[1:], PROCESS_START))
