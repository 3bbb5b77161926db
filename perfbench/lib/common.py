"""Paths, name lookups and seeds shared by the harness."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

# top-level module names that no run of the benchmark may load: JAX, its
# libraries, and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dualvgr_tpu")


def forbidden_modules(names) -> list[str]:
    """The names among ``names`` whose top-level name (before the first dot)
    is forbidden, compared whole: ``dualvgr_tpu_torch`` is not ``dualvgr_tpu``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "workloads" / f"{name}.json")


def config(name: str, bench: Path = BENCH) -> dict:
    return load_json(bench / "configs" / f"{name}.json")


def load_file_module(path: Path, name: str):
    """The module in ``path``, loaded under ``name`` (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, bench: Path = BENCH):
    """The ``read(trace)`` function of the per-layer metric ``metric``."""
    return load_file_module(bench / "metrics" / f"{metric}.py", f"perfbench_metric_{metric}").read


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: any
    non-negative whole number, however large."""
    words = [int(seed) >> (32 * i) & 0xFFFFFFFF for i in range(max(1, (int(seed).bit_length() + 31) // 32))]
    state = np.random.SeedSequence(words + [int.from_bytes(tag.encode(), "little") % (1 << 63)])
    lo, hi = state.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)
