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


@pytest.mark.parametrize("key,value", [("transfer_dtype", "bfloat16"), ("prefetch", 4), ("tensor_parallel", 2)])
def test_unhonoured_tpu_keys_parse_but_are_refused(key, value):
    """A tpu key the port does not honour yet parses, and is refused by
    ``model_runtime_kwargs`` rather than silently ignored."""
    cfg = tconfig.default_config()
    assert key in tconfig.UNHONOURED_TPU_KEYS
    cfg.tpu[key] = value
    with pytest.raises(NotImplementedError, match=f"tpu.{key}"):
        tconfig.model_runtime_kwargs(cfg, "cpu")
    assert set(tconfig.UNHONOURED_TPU_KEYS) == set(cfg.tpu) - {"compute_dtype", "use_pallas"}
