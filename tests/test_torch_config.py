"""The port's own config copy parses the shipped YAMLs like the JAX package's."""

import glob
import os

import pytest

from dualvgr_tpu import config as jconfig
from dualvgr_tpu_torch import config as tconfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_yaml_parses_like_jax_config(path):
    got = tconfig.cfg_from_file(path)
    want = jconfig.cfg_from_file(path)
    assert got == want  # the tpu section included
    assert tconfig.resolve_dataset_paths(got).dataset == jconfig.resolve_dataset_paths(want).dataset


def test_merge_rejects_unknown_keys_and_bad_types(tmp_path):
    p = tmp_path / "bad.yml"
    p.write_text("train:\n  nope: 1\n")
    with pytest.raises(KeyError, match="train.nope"):
        tconfig.cfg_from_file(str(p))
    p.write_text("train:\n  batch_size: 'big'\n")
    with pytest.raises(ValueError, match="train.batch_size"):
        tconfig.cfg_from_file(str(p))
    p.write_text("train:\n  lr: 1\n")
    assert tconfig.cfg_from_file(str(p)).train.lr == 1.0


@pytest.mark.parametrize("text", [
    "tpu:\n  compute_dtype: bfloat16\n",
    "tpu:\n  transfer_dtype: bfloat16\n",
    "tpu:\n  use_pallas: true\n",
    "tpu:\n  use_pallas: false\n  compute_dtype: float32\n",
    "train:\n  batch_size: 64\ntpu:\n  compute_dtype: auto\n  use_pallas: auto\n  prefetch: 4\n",
], ids=["compute_dtype", "transfer_dtype", "use_pallas_true", "use_pallas_false", "mixed"])
def test_tpu_section_parses_like_jax_config(tmp_path, text):
    """A YAML with ``tpu:`` keys that the JAX package accepts parses in the
    port to the same values, key for key (it used to raise KeyError)."""
    p = tmp_path / "c.yml"
    p.write_text(text)
    got, want = tconfig.cfg_from_file(str(p)), jconfig.cfg_from_file(str(p))
    assert got == want
    assert sorted(got.tpu) == sorted(want.tpu)
    for k, v in want.tpu.items():
        assert got.tpu[k] == v and type(got.tpu[k]) is type(v), k


def test_tpu_section_rejects_what_jax_rejects(tmp_path):
    p = tmp_path / "c.yml"
    p.write_text("tpu:\n  nope: 1\n")
    with pytest.raises(KeyError, match="tpu.nope"):
        tconfig.cfg_from_file(str(p))
    p.write_text("tpu:\n  prefetch: 'many'\n")
    with pytest.raises(ValueError, match="tpu.prefetch"):
        tconfig.cfg_from_file(str(p))


def test_resolvers_take_the_device():
    cfg = tconfig.default_config()
    assert cfg.tpu.compute_dtype == "auto" and cfg.tpu.use_pallas == "auto"
    # "auto": fp32 on every device (fp32 matmuls on the H100 are true fp32,
    # so bf16 streaming changes the numbers); the kernels on for CUDA only
    assert tconfig.model_runtime_kwargs(cfg, "cuda") == {"use_kernels": True, "compute_dtype": "float32"}
    assert tconfig.model_runtime_kwargs(cfg, "cpu") == {"use_kernels": False, "compute_dtype": "float32"}
    # explicit pins win, both ways
    cfg.tpu.compute_dtype, cfg.tpu.use_pallas = "bfloat16", False
    assert tconfig.model_runtime_kwargs(cfg, "cuda") == {"use_kernels": False, "compute_dtype": "bfloat16"}
    cfg.tpu.compute_dtype, cfg.tpu.use_pallas = "float32", True
    assert tconfig.model_runtime_kwargs(cfg, "cpu") == {"use_kernels": True, "compute_dtype": "float32"}
    cfg.tpu.compute_dtype = "float16"
    with pytest.raises(ValueError, match="compute_dtype"):
        tconfig.resolved_compute_dtype(cfg, "cuda")


# the tpu keys the train and validate CLIs read (dualvgr_tpu_torch/train.py)
CLI_TPU_KEYS = {"feature_cache_gb", "prefetch", "transfer_dtype", "log_every", "profile_dir", "grad_accum",
                   "autosave", "metrics_jsonl"}


@pytest.mark.parametrize("key,value", [("mesh_axis", "batch"), ("zero_opt", True), ("tensor_parallel", 2)])
def test_multi_device_tpu_keys_are_honoured(key, value, tmp_path, caplog):
    """The multi-device tpu keys, which the port refused before it had
    multi-device, are honoured: ``mesh_axis`` names the mesh's data axis,
    ``zero_opt`` is accepted (and places a state in a one-rank group),
    ``tensor_parallel: 2`` turns the kernels off with the JAX package's
    warning; every key the port does not hand to the CLIs is one of the
    multi-device keys or a model argument."""
    import torch.distributed as dist

    from dualvgr_tpu_torch import build_model
    from dualvgr_tpu_torch.parallel.tp import mesh_for, place_state
    from dualvgr_tpu_torch.train_lib import create_train_state, make_optimizer

    cfg = tconfig.default_config()
    cfg.tpu[key] = value
    cfg.tpu.use_pallas = True
    with caplog.at_level("WARNING"):
        kw = tconfig.model_runtime_kwargs(cfg, "cpu")
    assert kw == {"use_kernels": key != "tensor_parallel", "compute_dtype": "float32"}
    assert ("forces the plain (non-kernel) execution path" in caplog.text) == (key == "tensor_parallel")
    assert set(cfg.tpu) - {"compute_dtype", "use_pallas", "prng_impl"} - CLI_TPU_KEYS == {
        "mesh_axis", "tensor_parallel", "zero_opt"}
    if key == "tensor_parallel":
        return
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        mesh = mesh_for(cfg, "cpu")
        assert mesh.mesh_dim_names == (cfg.tpu.mesh_axis,)
        model = build_model(device="cpu", vision_dim=12, module_dim=16, word_dim=8, question_vocab_size=20,
                            num_answers=5, num_of_nodes=4)
        state = place_state(create_train_state(model, make_optimizer(1e-3, 10)), mesh,
                            zero_opt=cfg.tpu.zero_opt)
        assert state.placement.data.name == cfg.tpu.mesh_axis and state.placement.zero == cfg.tpu.zero_opt
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("key,value", [("transfer_dtype", "bfloat16"), ("prefetch", 4), ("grad_accum", 2),
                                       ("metrics_jsonl", "m.jsonl")])
def test_cli_tpu_keys_are_not_refused(key, value):
    cfg = tconfig.default_config()
    cfg.tpu[key] = value
    assert tconfig.model_runtime_kwargs(cfg, "cpu") == {"use_kernels": False, "compute_dtype": "float32"}


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_a_jax_prng_impl_is_refused(impl):
    cfg = tconfig.default_config()
    cfg.tpu.prng_impl = impl
    with pytest.raises(NotImplementedError, match="torch.Generator"):
        tconfig.model_runtime_kwargs(cfg, "cpu")
