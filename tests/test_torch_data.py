"""The port's data layer and validation against the JAX package's.

On the conftest ``synth_dir`` SVQA fixture and a small msvd-qa fixture
(built like tests/test_validate_buckets.py), both packages read the same
artifacts:

* ``VideoQADataLoader``: the same batch stream, in the same order, with the
  same ``valid``, questions, ids and features bit for bit (bf16 features
  against ``ml_dtypes``' cast), shuffled over two epochs or not, truncated,
  with the padded final batch, cached or file-backed; ``example_batch``
  consumes no RNG; an abandoned epoch and ``close()`` mid-epoch join the
  producer;
* ``FeatureStore``: ``from_array`` stores gather the rows HDF5 stores
  (cached and file-backed) gather;
* ``validate_lib.validate``: the same accuracy tuple from the same weights
  (``from_jax_variables``) on SVQA (15 buckets) and msvd-qa (5 buckets),
  with and without ``write_preds``;
* ``data.check``: the same errors and warnings, and the same exit codes.

The JAX loader and store gather and cast through the JAX package's native
library when it loads and through numpy when it does not; here they run on
a library of the module's own, always loaded (``test_torch_native.
jax_native_of_its_own``), so the JAX side takes one path in every worker.
"""

import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from dualvgr_tpu import train_lib as jtrain
from dualvgr_tpu import validate_lib as jvalidate
from dualvgr_tpu.config import default_config as jax_default_config
from dualvgr_tpu.data import VideoQADataLoader as JaxLoader
from dualvgr_tpu.data.check import check_dataset as jax_check_dataset
from dualvgr_tpu.data.features import FeatureStore as JaxStore
from dualvgr_tpu.data.synthetic import generate
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import build_model, create_train_state, make_optimizer, pred_step, validate_lib
from dualvgr_tpu_torch.config import default_config
from dualvgr_tpu_torch.data import Batch, FeatureStore, VideoQADataLoader
from dualvgr_tpu_torch.data import check as tcheck
from dualvgr_tpu_torch.parallel.mesh import prefetch_to_device
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import random_variables
from test_torch_native import jax_native_of_its_own

FEATURES = ("appearance_feat", "motion_feat")
# a validation row counts in the comparison only if the JAX logits' top-2
# margin is at least this: fp32 sums in another order may flip a closer tie
TIE_MARGIN = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library(tmp_path_factory):
    with jax_native_of_its_own(str(tmp_path_factory.mktemp("jax_native"))):
        yield


def loader_args(d, name="svqa", split="train", **kw):
    args = dict(
        question_pt=f"{d}/{name}_{split}_questions.pt",
        vocab_json=f"{d}/{name}_vocab.json",
        appearance_feat=f"{d}/{name}_appearance_feat.h5",
        motion_feat=f"{d}/{name}_motion_feat.h5",
        batch_size=8,
        shuffle=False,
    )
    args.update(kw)
    return args


def bits(x):
    """The raw bits of a float32 or bfloat16 array (numpy, ml_dtypes or torch)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def assert_same_batch(jb, pb):
    assert isinstance(pb, Batch)
    for field in Batch._fields:
        a, b = getattr(jb, field), getattr(pb, field)
        if a is None:
            assert b is None, field
        elif field in FEATURES:
            assert isinstance(b, torch.Tensor) and b.shape == a.shape, field
            np.testing.assert_array_equal(bits(b), bits(a), err_msg=field)
        else:
            assert b.dtype == a.dtype, (field, b.dtype, a.dtype)
            np.testing.assert_array_equal(b, a, err_msg=field)


@pytest.mark.parametrize("kw,epochs", [
    (dict(shuffle=True), 2),
    (dict(shuffle=False), 1),
    (dict(shuffle=True, batch_size=5, train_num=13), 2),  # truncation + a padded final batch of 3
    (dict(shuffle=True, transfer_dtype="bfloat16"), 2),
    (dict(shuffle=True, feature_cache_gb=0.0), 1),  # file-backed: sorted unique reads
    (dict(shuffle=True, feature_cache_gb=0.0, transfer_dtype="bfloat16"), 1),
])
def test_loader_yields_the_jax_batch_stream(synth_dir, kw, epochs):
    args = loader_args(synth_dir["dir"], **kw)
    jl, pl = JaxLoader(**args), VideoQADataLoader(**args)
    assert len(pl) == len(jl) and pl.num_samples == jl.num_samples
    assert pl.app_store.cached == jl.app_store.cached
    for _ in range(epochs):
        jbatches, pbatches = list(jl), list(pl)
        assert len(pbatches) == len(jbatches) == len(pl)
        for jb, pb in zip(jbatches, pbatches):
            assert_same_batch(jb, pb)
    if "train_num" in kw:
        assert pl.num_samples == 13 and pbatches[-1].valid.sum() == 3 and len(pbatches[-1].valid) == 5
    np.testing.assert_array_equal(pl.glove_matrix, jl.glove_matrix)
    pl.close()
    jl.close()


def test_example_batch_consumes_no_rng(synth_dir):
    args = loader_args(synth_dir["dir"], shuffle=True)
    jl, pl, fresh = JaxLoader(**args), VideoQADataLoader(**args), VideoQADataLoader(**args)
    for a, b in zip(jl.example_batch(2), pl.example_batch(2)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    assert pl.example_batch(2)[0].dtype == torch.float32
    assert pl._producer is None  # no producer thread started
    for jb, pb, fb in zip(jl, pl, fresh):
        assert_same_batch(jb, pb)
        assert_same_batch(jb, fb)


def test_svqa_category_strings_and_msvd_without_categories(synth_dir, msvd_dir, tmp_path):
    d = synth_dir["dir"]
    with open(f"{d}/svqa_train_questions.pt", "rb") as f:
        obj = pickle.load(f)
    names = ["count", "exist", "query_color", "query_size", "query_actiontype", "query_actiondir",
             "query_shape", "greater_than", "equal_to", "less_than", "equal_color", "equal_size",
             "equal_actiontype", "equal_actiondir", "equal_shape"]
    obj["question_category"] = [names[int(c)] for c in obj["question_category"]]
    path = str(tmp_path / "svqa_train_questions.pt")
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    strings = VideoQADataLoader(**loader_args(d, question_pt=path))
    ints = VideoQADataLoader(**loader_args(d))
    for a, b in zip(strings, ints):
        np.testing.assert_array_equal(a.question_category, b.question_category)
    msvd = next(iter(VideoQADataLoader(**loader_args(msvd_dir, name="msvd-qa"))))
    assert msvd.question_category is None


def test_abandoned_epoch_and_close_join_the_producer(synth_dir):
    loader = VideoQADataLoader(**loader_args(synth_dir["dir"], shuffle=True, batch_size=4, prefetch=1))
    it = iter(loader)
    next(it)
    producer = loader._producer
    assert producer is not None and producer.is_alive()
    it.close()  # the consumer abandons the epoch
    assert loader._producer is None and not producer.is_alive()
    assert len(list(loader)) == len(loader)  # a later epoch runs whole
    it = iter(loader)
    next(it)
    producer = loader._producer
    loader.close()  # close mid-epoch
    producer.join(timeout=10)
    assert not producer.is_alive() and loader._producer is None


def test_a_producer_failure_is_raised_in_the_consumer(synth_dir, monkeypatch):
    loader = VideoQADataLoader(**loader_args(synth_dir["dir"]))

    def broken(rows, out=None, n_threads=None):
        raise OSError("feature file went away")

    monkeypatch.setattr(loader.motion_store, "gather", broken)
    with pytest.raises(OSError, match="went away"):
        list(loader)
    assert loader._producer is None


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_from_array_stores_gather_what_hdf5_stores_gather(synth_dir, store_dtype):
    import h5py

    path = synth_dir["appearance"]
    with h5py.File(path, "r") as f:
        ids, feats = f["ids"][()], f["resnet_features"][()]
    rows = np.random.RandomState(0).randint(0, len(ids), 50)  # duplicates, any order
    mem = FeatureStore.from_array(ids, feats, "resnet_features", store_dtype=store_dtype)
    cached = FeatureStore(path, "resnet_features", store_dtype=store_dtype)
    on_disk = FeatureStore(path, "resnet_features", cache_gb=0.0, store_dtype=store_dtype)
    jax_store = JaxStore(path, "resnet_features", store_dtype=store_dtype)
    assert mem.cached and cached.cached and not on_disk.cached
    assert mem.shape == cached.shape == on_disk.shape == feats.shape
    assert mem.id_to_index == cached.id_to_index == jax_store.id_to_index
    want = bits(jax_store.gather(rows))
    for store in (mem, cached, on_disk):
        np.testing.assert_array_equal(bits(store.gather(rows)), want)
        out = torch.empty((len(rows), *feats.shape[1:]), dtype=mem.out_dtype)
        assert store.gather(rows, out=out).data_ptr() == out.data_ptr()
        np.testing.assert_array_equal(bits(out), want)
    on_disk.close()
    # a store handed to the loader takes the place of the file
    loader = VideoQADataLoader(**loader_args(synth_dir["dir"], appearance_feat=mem,
                                             transfer_dtype=store_dtype))
    for jb, pb in zip(JaxLoader(**loader_args(synth_dir["dir"], transfer_dtype=store_dtype)), loader):
        assert_same_batch(jb, pb)


def test_bf16_stores_cast_as_ml_dtypes_bit_for_bit(tmp_path):
    """The bf16 cast of a store (in memory, cached file, file-backed) is
    ml_dtypes' round-to-nearest-even, ties and the neighbours of ties
    included, chunk boundaries crossed."""
    import h5py
    import ml_dtypes

    rng = np.random.RandomState(1)
    feats = (rng.randn(300, 2, 16) * np.exp(rng.uniform(-20, 20, (300, 2, 16)))).astype(np.float32)
    raw = feats.view(np.uint32)
    raw[:100] = (raw[:100] & 0xFFFF0000) | 0x8000  # exact ties between two bf16 values
    raw[100:150] = (raw[100:150] & 0xFFFF0000) | 0x7FFF
    raw[150:200] = (raw[150:200] & 0xFFFF0000) | 0x8001
    want = bits(feats.astype(ml_dtypes.bfloat16))
    ids = np.arange(300)
    path = str(tmp_path / "feats.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("resnext_features", data=feats)
        f.create_dataset("ids", data=ids)
    rows = np.arange(300)[::-1]
    for store in (FeatureStore.from_array(ids, feats, "resnext_features", store_dtype="bfloat16"),
                  FeatureStore(path, "resnext_features", store_dtype="bfloat16"),
                  FeatureStore(path, "resnext_features", cache_gb=0.0, store_dtype="bfloat16")):
        np.testing.assert_array_equal(bits(store.gather(rows)), want[rows])


def test_a_float32_store_feeds_a_bfloat16_loader(synth_dir):
    """A handed-in fp32 store under transfer_dtype bfloat16: each batch is
    cast with round-to-nearest-even, as the JAX bf16 store casts."""
    import h5py

    d = synth_dir["dir"]
    with h5py.File(synth_dir["appearance"], "r") as f:
        mem = FeatureStore.from_array(f["ids"][()], f["resnet_features"][()], "resnet_features")
    args = loader_args(d, transfer_dtype="bfloat16", shuffle=True)
    for jb, pb in zip(JaxLoader(**args), VideoQADataLoader(**dict(args, appearance_feat=mem))):
        assert_same_batch(jb, pb)


def test_prefetch_to_device_passes_through_on_the_cpu():
    items = [(torch.ones(2), np.zeros(3)), (torch.zeros(1), None)]
    out = list(prefetch_to_device(iter(items), "cpu", size=2))
    assert len(out) == 2 and all(a is b for a, b in zip(out, items))


@pytest.fixture(scope="module")
def msvd_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("msvd"))
    generate(out, dataset="msvd-qa", num_videos=20, questions_per_video=5, num_clips=3, vision_dim=16,
             frames=2, num_answers=10, vocab_size=30, max_q_len=7, word_dim=8, module_dim=16, batch_size=8)
    return out


def _dims(loader, vision, module, word, nodes):
    return dict(vision_dim=vision, module_dim=module, word_dim=word,
                question_vocab_size=len(loader.vocab["question_token_to_idx"]),
                num_answers=len(loader.vocab["answer_token_to_idx"]), num_of_nodes=nodes,
                graph_layers=1, unit_layers=1)


@pytest.mark.parametrize("dataset", ["svqa", "msvd-qa"])
def test_validation_returns_the_jax_accuracy_tuple(synth_dir, msvd_dir, dataset):
    if dataset == "svqa":
        d, dims, split = synth_dir["dir"], (32, 32, 16, 4), "val"
    else:
        d, dims, split = msvd_dir, (16, 16, 8, 3), "test"
    args = loader_args(d, name=dataset, split=split, batch_size=4)
    jl, pl = JaxLoader(**args), VideoQADataLoader(**args)
    kw = _dims(jl, *dims)
    jmodel = JaxDualVGR(**kw)
    example = next(iter(jl))
    variables = random_variables(jmodel, (example.appearance_feat[:1], example.motion_feat[:1],
                                          example.question[:1], example.question_len[:1]), seed=3)
    jstate = jtrain.TrainState(step=0, params=variables["params"], batch_stats=variables["batch_stats"],
                               opt_state=None, rng=jax.random.PRNGKey(0))
    model = build_model(device="cpu", **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    state = create_train_state(model, make_optimizer(1e-3, len(pl)))  # the model in training mode
    jcfg, cfg = jax_default_config(), default_config()
    jcfg.dataset.name = cfg.dataset.name = dataset

    # rows whose JAX logits are within TIE_MARGIN of a tie are left out of
    # the row comparison; the tuples are compared whole when there are none
    eval_fn = jtrain.jit_eval_step(jmodel)
    ties = set()
    for b in jl:
        logits = np.asarray(eval_fn(jstate, (b.appearance_feat, b.motion_feat, b.question, b.question_len)))
        top2 = np.sort(logits, axis=1)[:, -2:]
        ties |= {int(q) for q, m, v in zip(b.question_idx, top2[:, 1] - top2[:, 0], b.valid) if v and m < TIE_MARGIN}
    print(f"{len(ties)} validation rows within {TIE_MARGIN} of a tie left out of the comparison (expected 0)")
    want = jvalidate.validate(jcfg, jtrain.jit_pred_step(jmodel), jstate, jl, write_preds=True)
    got = validate_lib.validate(cfg, pred_step, state, pl, write_preds=True, device="cpu")
    assert state.model.training  # pred_step put it back in training mode
    assert got[2:5] == want[2:5]  # ground truths, video and question ids
    rows = [i for i, q in enumerate(want[4]) if q not in ties]
    assert [got[1][i] for i in rows] == [want[1][i] for i in rows]  # the predicted answers
    if not ties:
        assert got == want
        plain = validate_lib.validate(cfg, pred_step, state, pl, device="cpu")
        assert plain == jvalidate.validate(jcfg, jtrain.jit_pred_step(jmodel), jstate, jl)
        assert plain == (want[0], *want[5:])
    assert len(got) == 5 + (15 if dataset == "svqa" else 5)
    assert validate_lib.category_names(dataset) == jvalidate.category_names(dataset)


def test_pred_step_restores_the_mode_and_takes_the_eval_argmax(synth_dir):
    loader = VideoQADataLoader(**loader_args(synth_dir["dir"]))
    model = build_model(device="cpu", **_dims(loader, 32, 32, 16, 4))
    b = next(iter(loader))
    inputs = (b.appearance_feat, b.motion_feat, b.question, b.question_len)
    want = model(*(torch.as_tensor(x) for x in inputs)).logits.argmax(1)
    for mode in (True, False):
        model.train(mode)
        got = pred_step(model, inputs)
        assert model.training is mode
        assert got.dtype == torch.int64 and torch.equal(got, want)


def _check_args(d, name="svqa"):
    return (f"{d}/{name}_vocab.json",
            {m: f"{d}/{name}_{m}_questions.pt" for m in ("train", "val", "test")},
            f"{d}/{name}_appearance_feat.h5", f"{d}/{name}_motion_feat.h5")


def test_dataset_check_reports_what_the_jax_check_reports(synth_dir, tmp_path, capsys):
    d = str(tmp_path / "broken")
    shutil.copytree(synth_dir["dir"], d, ignore=shutil.ignore_patterns("results"))
    assert tcheck.check_dataset(*_check_args(d), num_of_nodes=4) == ([], [])
    with open(f"{d}/svqa_val_questions.pt", "rb") as f:
        obj = pickle.load(f)
    obj["questions"][0, -1] = 5  # a token beyond the row's length
    obj["answers"][1] = 999  # outside the answer vocab
    del obj["question_category"]
    with open(f"{d}/svqa_val_questions.pt", "wb") as f:
        pickle.dump(obj, f)
    got = tcheck.check_dataset(*_check_args(d), num_of_nodes=8)
    assert got == jax_check_dataset(*_check_args(d), num_of_nodes=8)
    assert len(got[0]) == 4, got
    cfg = f"{d}/svqa_synth.yml"
    with open(cfg) as f:
        text = f.read().replace(synth_dir["dir"], d)
    with open(cfg, "w") as f:
        f.write(text)
    assert tcheck.main(["--cfg", f"{synth_dir['dir']}/svqa_synth.yml"]) == 0
    assert tcheck.main(["--cfg", cfg]) == 1
    assert "ERROR" in capsys.readouterr().out
    os.remove(f"{d}/svqa_test_questions.pt")
    assert tcheck.main(["--cfg", cfg]) == 1
