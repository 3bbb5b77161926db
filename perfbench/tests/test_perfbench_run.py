"""``run.py`` refuses to run without the card, with no fallback to the CPU,
and without the program beside it."""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from perfbench.lib import common

ARGS = ["--workload", "msvd-qa.train", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def run(cwd, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run(common.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_benchmark_alone_is_not_enough():
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(common.BENCH, Path(tmp) / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(common.ROOT / "BENCHMARK.json", tmp)
        out = run(tmp)
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run(common.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
