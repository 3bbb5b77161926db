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
    want.pop("tpu")  # the JAX package's backend knobs; the port's device is an argument
    assert got == want
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
