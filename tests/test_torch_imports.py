"""The port stands alone and runs on the card unless told otherwise.

* Importing every module of ``dualvgr_tpu_torch`` (the bf16 streaming and
  projection modules, the port's probe, the data layer with the native
  gather and the fixture generator, the CLIs, validation and checkpoints,
  the export, the HTTP front, the tokenizer, the checkpoint interchange,
  the FLOP count, the zoos, the backbones, the preprocessing, predict,
  the extraction bench and the multi-device layer included) and
  ``chip_smoke`` loads none of jax, flax, orbax, the JAX package
  ``dualvgr_tpu``, ``benchmarks``,
  ``preprocess``, ``nltk``, ``h5py``, ``ml_dtypes``, ``cv2`` or ``PIL``,
  and runs no CLI's ``main``.
* The entry points default to ``device="cuda"`` and raise on a machine
  without CUDA instead of answering through the plain path; so do the
  export, serve and port_reference CLIs without ``--platforms cpu`` /
  ``--device cpu``.
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
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "dualvgr_tpu", "benchmarks",
                                            "preprocess", "nltk", "h5py", "ml_dtypes", "cv2", "PIL"))
        print(len(mods), bad)
        assert not bad, bad
        for m in ("ops.precision", "ops.proj_kernel", "bench.proj_probe", "data.vocab", "data.features",
                  "data.loader", "data.check", "parallel.mesh", "parallel.tp", "parallel.comm", "parallel.dryrun",
                  "train", "validate", "validate_lib",
                  "utils.checkpoint", "utils.logging", "export", "serve", "data.questions",
                  "utils.port_reference", "utils.flops", "models.graph_zoo", "models.attention_zoo",
                  "models.utils_zoo", "models.fusions", "data.native", "data.synthetic",
                  "models.backbones.resnet2d", "models.backbones.resnext3d", "models.backbones.resnet3d_zoo",
                  "preprocess.datautils.questions_common", "preprocess.datautils.svqa",
                  "preprocess.datautils.msvd_qa", "preprocess.datautils.msrvtt_qa", "preprocess.questions",
                  "preprocess.features", "preprocess.resize", "predict", "bench.extraction_bench"):
            assert "dualvgr_tpu_torch." + m in mods, m
        assert len(mods) >= 30, mods
        # importing the CLIs runs no main: nothing was trained or logged
        import logging
        assert not logging.getLogger().handlers, logging.getLogger().handlers
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


def test_deployment_clis_default_to_cuda_and_raise_without_it(synth_dir, tmp_path):
    _no_cuda()
    from dualvgr_tpu_torch import ReplicatedEngine, export, serve, validate_lib
    from dualvgr_tpu_torch.config import default_config
    from dualvgr_tpu_torch.parallel import dryrun
    from dualvgr_tpu_torch.serving import per_device_predict_fns
    from dualvgr_tpu_torch.utils import port_reference

    cfg = synth_dir["config"]
    with pytest.raises(RuntimeError, match="cuda"):
        export.main(["--cfg", cfg, "--out", str(tmp_path / "x.dvgr")])
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--cfg", cfg])
    with pytest.raises(RuntimeError, match="cuda"):
        port_reference.main(["import", str(tmp_path / "ref.pt"), str(tmp_path / "ckpt")])
    with pytest.raises(RuntimeError, match="cuda"):
        port_reference.main(["export", str(tmp_path / "ckpt"), str(tmp_path / "ref.pt")])
    with pytest.raises(RuntimeError, match="cuda"):
        export.load_artifact(str(tmp_path / "x.dvgr"))
    with pytest.raises(RuntimeError, match="cuda"):
        ReplicatedEngine([lambda *a: a])
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--nproc", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.spawn(dryrun.steps_on_rank, 2, ([{}],))
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_steps({})
    with pytest.raises(RuntimeError, match="cuda"):
        validate_lib.validate(default_config(), None, None, None)
    with pytest.raises(ValueError, match="device_count"):
        per_device_predict_fns(str(tmp_path / "x.dvgr"), devices=["cuda:0"])
