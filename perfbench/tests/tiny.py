"""A cell at a size a CPU test can hold: the cell's own files with the
model and the dataset shrunk, run by its driver on the CPU."""

from __future__ import annotations

import copy
import tempfile

import torch

from perfbench.lib import common
from perfbench.lib.harness import Context

TINY_MODEL = dict(vision_dim=32, module_dim=16, word_dim=8, question_vocab_size=40, num_answers=1000,
                  num_of_nodes=4, frames_per_clip=3, question_len=6)
TINY_DATA = dict(train_videos=10, train_questions=160, test_videos=12, test_questions=480)
TINY_CELL = dict(batch_size=32, rate=300, clients=8, warmup_seconds=0.2, readings_seconds=0.5,
                 checked_requests=96, checked_batches=50, warmup_steps=1, max_batch=8, max_q_len=8)


def tiny(cell: str) -> tuple[dict, dict]:
    workload = copy.deepcopy(common.workload(cell))
    config = copy.deepcopy(common.config(workload["config"]))
    config["model"].update(TINY_MODEL)
    config.update(TINY_DATA)
    config["question_length"] = {"offset": 2, "log_mean": 0.7, "log_sigma": 0.5, "max": 6}
    workload.update({k: v for k, v in TINY_CELL.items() if k in workload})
    return workload, config


def run_tiny(cell: str, *, seed: int = 1234567890123, seconds: float = 0.5, variant=None, faults=(),
             readings_only=False, limits=None) -> dict:
    """The driver's result for ``cell`` at the tiny size on the CPU."""
    workload, config = tiny(cell)
    if limits is not None:
        workload["limits"] = limits
    driver = __import__(f"perfbench.drivers.{workload['driver']}", fromlist=["run"])
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(cell, workload, config, seed, seconds, False, torch.device("cpu"), tmp, variant=variant,
                      faults=tuple(faults), readings_only=readings_only)
        out = driver.run(ctx)
    out["log"] = ctx.log
    return out
