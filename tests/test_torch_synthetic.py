"""The port's fixture generator (``dualvgr_tpu_torch.data.synthetic``)
against the JAX package's (``dualvgr_tpu.data.synthetic``): for the same
seed and arguments the two write equal files — the question pickles key by
key, the HDF5 arrays bit for bit, the vocab json, the YAML apart from its
paths — and return the same statistics. Its CLI writes them too.
"""

import os
import pickle
import sys

import h5py
import numpy as np
import pytest

from dualvgr_tpu.data.synthetic import generate as jax_generate
from dualvgr_tpu_torch.data import synthetic

SMALL = dict(num_videos=12, questions_per_video=2, num_clips=3, vision_dim=24, frames=4, num_answers=9,
             vocab_size=30, max_q_len=6, word_dim=8, module_dim=16, batch_size=4, max_epochs=1)


def _equal(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, where


def assert_same_fixture(d_port, d_jax, ret_port, ret_jax, name):
    for split in ("train", "val", "test"):
        f = f"{name}_{split}_questions.pt"
        with open(os.path.join(d_port, f), "rb") as fp, open(os.path.join(d_jax, f), "rb") as fj:
            p, j = pickle.load(fp), pickle.load(fj)
        assert sorted(p) == sorted(j)
        for k in j:
            if isinstance(j[k], list):
                assert len(p[k]) == len(j[k])
                for i, (a, b) in enumerate(zip(p[k], j[k])):
                    _equal(a, b, f"{f}[{k}][{i}]")
            else:
                _equal(p[k], j[k], f"{f}[{k}]")
    for f, ds in ((f"{name}_appearance_feat.h5", "resnet_features"), (f"{name}_motion_feat.h5", "resnext_features")):
        with h5py.File(os.path.join(d_port, f)) as hp, h5py.File(os.path.join(d_jax, f)) as hj:
            assert sorted(hp) == sorted(hj) == sorted(["ids", ds])
            for k in hj:
                a, b = hp[k][()], hj[k][()]
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    f = f"{name}_vocab.json"
    with open(os.path.join(d_port, f)) as fp, open(os.path.join(d_jax, f)) as fj:
        assert fp.read() == fj.read()
    f = f"{name}_synth.yml"
    with open(os.path.join(d_port, f)) as fp, open(os.path.join(d_jax, f)) as fj:
        assert fp.read().replace(d_port, "DIR") == fj.read().replace(d_jax, "DIR")
    strip = lambda r, d: {k: (v.replace(d, "DIR") if isinstance(v, str) else v) for k, v in r.items()}  # noqa: E731
    assert strip(ret_port, d_port) == strip(ret_jax, d_jax)


@pytest.mark.parametrize("dataset,extra", [
    ("svqa", {}),
    ("msrvtt-qa", {"seed": 5}),
    ("svqa", {"label_noise": 0.3, "eval_questions_per_video": 3, "category_names": True}),
])
def test_the_port_writes_the_jax_generators_files(tmp_path, dataset, extra):
    kw = dict(SMALL, dataset=dataset, **extra)
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    ret_port = synthetic.generate(d_port, **kw)
    ret_jax = jax_generate(d_jax, **kw)
    assert_same_fixture(d_port, d_jax, ret_port, ret_jax, dataset)


def test_the_cli_writes_the_jax_generators_files(tmp_path, monkeypatch, capsys):
    d_port, d_jax = str(tmp_path / "port"), str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["synthetic", "--out", d_port, "--dataset", "msvd-qa", "--num-videos", "10",
                                      "--num-clips", "2", "--vision-dim", "16", "--frames", "3", "--answers", "7",
                                      "--vocab", "25", "--word-dim", "8", "--module-dim", "16", "--seed", "2"])
    synthetic.main()
    assert "config: " in capsys.readouterr().out
    jax_generate(d_jax, dataset="msvd-qa", num_videos=10, num_clips=2, vision_dim=16, frames=3, num_answers=7,
                 vocab_size=25, word_dim=8, module_dim=16, seed=2)
    assert_same_fixture(d_port, d_jax, {}, {}, "msvd-qa")
