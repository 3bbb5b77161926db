"""What the card's measuring tools share: a CUDA-event timer and the runner of an A/B against an earlier tree.

``time_ms`` times a callable on the card. ``against_baseline`` runs an A/B
tool's ``--measure`` in an earlier checkout of the repo and in this one, in
turns, one process each, and prints each timing per run and this tree's
mean against the baseline's: each tree's own copy of the tool, or, with
``script``, this tree's copy of it on each tree's package (for a tool the
earlier checkout lacks or whose measurement it cannot run).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]


def time_ms(fn, iters, warmup=1):
    """Mean device ms of ``fn()`` over ``iters`` calls after ``warmup``
    calls, with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run_in(module: str, tree: Path, script: Path | None = None) -> dict:
    """``python -m <module> --measure`` (or ``python <script> --measure``)
    with ``tree``'s package, in a process of its own: the timings of the
    ``RESULT`` JSON line it prints."""
    env = dict(os.environ, PYTHONPATH=str(tree))
    cmd = [sys.executable, str(script)] if script else [sys.executable, "-m", module]
    proc = subprocess.run([*cmd, "--measure"], cwd=tree, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"measure in {tree} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def against_baseline(module: str, baseline: Path, script: Path | None = None):
    """``module``'s measurement (``script``'s, run in both trees, if given)
    in ``baseline`` and in this tree, in turns (baseline, this, this,
    baseline); prints each timing's runs and this tree's mean against the
    baseline's."""
    runs = {"baseline": [], "this": []}
    for who in ("baseline", "this", "this", "baseline"):
        runs[who].append(run_in(module, baseline if who == "baseline" else ROOT, script))
    for key in runs["this"][0]:
        base = [r[key] for r in runs["baseline"]]
        this = [r[key] for r in runs["this"]]
        change = sum(this) / sum(base) - 1.0
        print(f"[{key}] baseline " + " / ".join(f"{m:.4f}" for m in base) + " ms; this "
              + " / ".join(f"{m:.4f}" for m in this) + f" ms; change {100 * change:+.2f}%", flush=True)
