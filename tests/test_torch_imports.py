"""The port stands alone and runs on the card unless told otherwise.

* Importing every module of ``dualvgr_tpu_torch`` (the bf16 streaming and
  projection modules and the port's probe included) and ``chip_smoke``
  loads none of jax, flax, the JAX package ``dualvgr_tpu`` or
  ``benchmarks``.
* The entry points default to ``device="cuda"`` and raise on a machine
  without CUDA instead of answering through the plain path.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import dualvgr_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(dualvgr_tpu_torch.__path__, "dualvgr_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        import chip_smoke
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "dualvgr_tpu", "benchmarks"))
        print(len(mods), bad)
        assert not bad, bad
        for m in ("ops.precision", "ops.proj_kernel", "bench.proj_probe"):
            assert "dualvgr_tpu_torch." + m in mods, m
        assert len(mods) >= 17, mods
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it")


def test_build_model_defaults_to_cuda_and_raises_without_it():
    _no_cuda()
    from dualvgr_tpu_torch import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        build_model(vision_dim=8, module_dim=8, word_dim=4, num_of_nodes=2, unit_layers=1)


def test_predict_fn_and_engine_refuse_cuda_without_it():
    _no_cuda()
    from dualvgr_tpu_torch import BatchingEngine, build_model, build_predict_fn

    model = build_model(device="cpu", vision_dim=8, module_dim=8, word_dim=4,
                        question_vocab_size=5, num_answers=3, num_of_nodes=2, unit_layers=1)
    with pytest.raises(RuntimeError, match="cuda"):
        build_predict_fn(model, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        BatchingEngine(lambda *a: a)
    # a model left on the CPU is no model for a CUDA predict fn either way
    with pytest.raises((RuntimeError, ValueError)):
        build_predict_fn(model, 2, device="cuda")
