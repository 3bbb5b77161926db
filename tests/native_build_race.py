"""Processes building a native gather library into one directory at once.

    python tests/native_build_race.py [--procs 6] [--trials 3] [--modes jax-shared jax-private port]

Each trial starts ``--procs`` processes on an empty directory, holds them at
a start line until every one has imported its module, and then lets them go
together. It prints one JSON line a mode, with the count of each outcome
over the trials:

* ``jax-shared``: each process points the JAX package's
  ``dualvgr_tpu.data.native._LIB_PATH`` at the same file and calls
  ``_load()``. Its ``g++ -o`` writes that file in place, so a process may
  dlopen a library another one is still writing and keep ``None`` for the
  rest of its life: the state of a test worker whose JAX gather returned
  ``None``.
* ``jax-private``: the same, each process on a file of its own, as the
  port's tests load the JAX library (``test_torch_native.
  jax_native_of_its_own``).
* ``port``: each process calls the port's
  ``dualvgr_tpu_torch.data.native.build`` on the shared directory, loads
  the library through ctypes as ``load()`` does, and gathers 101 rows of a
  seeded (50, 3, 11) float32 source, which must equal
  ``torch.index_select`` bit for bit.

A process reports ``ok``, ``none`` (the JAX loader's fallback), ``mismatch``
or the error it raised. ``tests/test_torch_native.py`` runs the ``port``
mode with six processes.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MODES = ("jax-shared", "jax-private", "port")

WORKER = r"""
import ctypes, sys, time
from pathlib import Path

mode, control, build, i = sys.argv[1], Path(sys.argv[2]), Path(sys.argv[3]), sys.argv[4]
if mode.startswith("jax"):
    from dualvgr_tpu.data import native
    native._LIB_PATH = str(build / ("_gather.so" if mode == "jax-shared" else f"_gather-{i}.so"))
else:
    import numpy as np
    import torch
    from dualvgr_tpu_torch.data import native
(control / f"ready-{i}").touch()
while not (control / "go").exists():
    time.sleep(0.0005)
try:
    if mode.startswith("jax"):
        print("ok" if native._load() is not None else "none")
    else:
        lib = native._declare(ctypes.CDLL(str(native.build(build_dir=build))))
        rs = np.random.RandomState(0)
        src = torch.from_numpy(rs.randn(50, 3, 11).astype(np.float32))
        rows = rs.randint(0, 50, 101).astype(np.int64)
        out = torch.empty(len(rows), 3, 11)
        rc = lib.gather_rows(src.data_ptr(), 50, 3 * 11 * 4, rows.ctypes.data, len(rows), out.data_ptr(), 3)
        want = torch.index_select(src, 0, torch.from_numpy(rows))
        print("ok" if rc == 0 and torch.equal(out.view(torch.int32), want.view(torch.int32)) else "mismatch")
except Exception as e:
    print(f"{type(e).__name__}: {e}".replace("\n", " "))
"""


def race(mode: str, procs: int, directory, timeout: float = 300.0) -> list[str]:
    """One trial: ``procs`` processes of ``mode`` let go together on
    ``directory``/build (made empty); each one's outcome, in start order."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    control = Path(directory)
    build = control / "build"
    build.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    ps = [subprocess.Popen([sys.executable, "-c", WORKER, mode, str(control), str(build), str(i)], cwd=ROOT,
                           env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
          for i in range(procs)]
    try:
        deadline = time.monotonic() + timeout
        while not all((control / f"ready-{i}").exists() for i in range(procs)):
            if any(p.poll() is not None for p in ps) or time.monotonic() > deadline:
                break  # a process died before the start line, or time ran out: read what they said
            time.sleep(0.01)
        (control / "go").touch()
        outs = []
        for p in ps:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            lines = out.strip().splitlines()
            outs.append(lines[-1] if p.returncode == 0 and lines else f"exit {p.returncode}: {err.strip()[-500:]}")
        return outs
    finally:
        for p in ps:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--procs", type=int, default=6)
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    args = parser.parse_args(argv)
    for mode in args.modes:
        counts = collections.Counter()
        for _ in range(args.trials):
            with tempfile.TemporaryDirectory(prefix="native_build_race_") as tmp:
                counts.update(race(mode, args.procs, tmp))
        print(json.dumps({"mode": mode, "procs": args.procs, "trials": args.trials,
                          "outcomes": dict(counts.most_common())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
