"""The port's native host data path (``data/native.py``, ``data/_gather.cpp``)
against the JAX package's (``dualvgr_tpu/data/native.py``) and torch.

* ``gather_rows`` is bit for bit ``torch.index_select`` and the JAX
  package's gather, over dtypes, duplicate rows and thread counts, writes
  into the caller's ``out`` and raises IndexError for a row out of range;
* ``cast_f32_to_bf16`` is bit for bit the JAX package's cast (ml_dtypes'
  bits: round to nearest even, a carry into inf, +-inf, NaNs keeping their
  sign and payload, quieted) on every input tried, and equal to
  ``Tensor.to(torch.bfloat16)`` on the finite ones; on NaNs torch writes
  the canonical 0x7FC0 / 0xFFC0 instead, which the port does not follow;
* a failed build raises with the compiler's output;
* the port's FeatureStore and loader give the JAX loader's batches with
  ``num_workers`` 1 and 4, through the native gather (no index_select);
* six processes building the port's library into one empty directory at
  once all load it and gather right, and leave one library and no
  temporary file (``native_build_race.py``, mode ``port``).

The JAX side of every comparison here runs on a JAX library of the
module's own (``jax_native_of_its_own``). The JAX package builds its
``_gather.so`` in place, inside the package, and keeps ``None`` for the
rest of a process whose first load failed; test workers that build it at
once can dlopen each other's half-written file and fall back, and then
the JAX gather returns ``None``. A library that does not build or load
here fails the module instead.
"""

import contextlib
import os
import subprocess
import types

import numpy as np
import pytest
import torch

from dualvgr_tpu.data import native as jax_native
from dualvgr_tpu.data.loader import VideoQADataLoader as JaxLoader
from dualvgr_tpu_torch.data import FeatureStore, VideoQADataLoader, native
from tests.native_build_race import race


@contextlib.contextmanager
def jax_native_of_its_own(build_dir):
    """The JAX package's ``data/native.py`` on a library of its own: its
    ``_build`` compiles its ``_SRC`` with its flags into ``build_dir``
    (a path no other process writes) and ``_load`` loads it; the module's
    ``_LIB_PATH``, ``_lib`` and ``_tried`` are restored on exit. Fails,
    with the output of the ``g++`` command ``_build`` ran, when the
    library does not build or load."""
    runs = []

    def run(cmd, **kw):
        runs.append(subprocess.run(cmd, **kw))
        return runs[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", os.path.join(build_dir, "_gather.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        with pytest.MonkeyPatch.context() as build_mp:
            build_mp.setattr(jax_native, "subprocess", types.SimpleNamespace(run=run))
            lib = jax_native._load()
        if lib is None:
            said = "\n".join(f"{' '.join(p.args)} exited {p.returncode}:\n{p.stdout.decode()}{p.stderr.decode()}"
                             for p in runs)
            pytest.fail(f"the JAX package's native library did not build or load at {jax_native._LIB_PATH}\n"
                        f"{said or 'the build did not finish'}")
        yield lib


@pytest.fixture(scope="module", autouse=True)
def _jax_native_library(tmp_path_factory):
    with jax_native_of_its_own(str(tmp_path_factory.mktemp("jax_native"))):
        yield


def _bits(t) -> np.ndarray:
    """A tensor's or array's elements as integers of their width."""
    a = t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy() if isinstance(t, torch.Tensor) \
        and t.is_floating_point() else np.asarray(t)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


@pytest.mark.parametrize("n_threads", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int32])
def test_gather_rows_is_index_select_and_the_jax_gather(dtype, n_threads):
    rs = np.random.RandomState(n_threads)
    src = torch.from_numpy(rs.randn(50, 3, 11).astype(np.float32) * 10).to(dtype)
    rows = rs.randint(0, 50, 101)  # duplicates, any order
    got = native.gather_rows(src, rows, n_threads=n_threads)
    np.testing.assert_array_equal(_bits(got), _bits(native.gather_rows_reference(src, rows)))
    src_np = src.view(torch.int16).numpy() if dtype == torch.bfloat16 else src.numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jax_native.gather_rows(src_np, rows, n_threads=n_threads)))


def test_gather_rows_writes_into_the_callers_tensor():
    src = torch.randn(9, 4, 5)
    out = torch.full((6, 4, 5), float("nan"))
    rows = np.array([8, 0, 8, 3, 1, 1])
    assert native.gather_rows(src, rows, out=out).data_ptr() == out.data_ptr()
    assert torch.equal(out, src[torch.from_numpy(rows)])
    with pytest.raises(ValueError):
        native.gather_rows(src, rows, out=torch.empty(6, 4, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        native.gather_rows(src, rows, out=torch.empty(6, 5, 4).transpose(1, 2))


@pytest.mark.parametrize("rows", [[0, 5], [-1], [2, 100, 1]])
def test_an_out_of_range_row_raises(rows):
    with pytest.raises(IndexError):
        native.gather_rows(torch.zeros(5, 3), np.asarray(rows))


SPECIAL_BITS = np.array([
    0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,  # zeros, denormals
    0x3F808000, 0x3F818000, 0x3F80C000, 0x3F807FFF,  # ties to even, above and below
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F8000, 0x7F7F7FFF,  # carry into inf, the largest finite
    0x7F800000, 0xFF800000,  # +-inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,  # quiet and signalling NaNs, both signs
    0x7FA12345, 0xFFB00000, 0x7FFFFFFF,  # NaN payloads
], dtype=np.uint32)


def test_cast_is_the_jax_cast_bit_for_bit():
    rs = np.random.RandomState(0)
    x = np.concatenate([SPECIAL_BITS, rs.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)])
    src = torch.from_numpy(x.view(np.float32).copy())
    want = jax_native.cast_f32_to_bf16(x.view(np.float32)).view(np.int16)
    for n_threads in (1, 4):
        got = native.cast_f32_to_bf16(src, n_threads=n_threads)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


def test_a_worker_that_lost_the_jax_build_race_still_compares(monkeypatch, tmp_path):
    """The state of a worker that dlopened another's half-written
    ``_gather.so``: the JAX gather and cast give ``None`` (where the
    module's comparisons took the JAX library as it came, they raised
    ``KeyError: 8`` in ``_bits``). On a library of their own they run and
    pass, and the losing state is back afterwards."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    assert jax_native.gather_rows(np.zeros((4, 3), np.float32), np.array([2, 0])) is None
    assert jax_native.cast_f32_to_bf16(np.zeros(5, np.float32)) is None
    with jax_native_of_its_own(str(tmp_path)):
        for dtype in (torch.float32, torch.bfloat16):
            test_gather_rows_is_index_select_and_the_jax_gather(dtype, 8)
        test_cast_is_the_jax_cast_bit_for_bit()
    assert jax_native._lib is None and jax_native._tried


def test_cast_equals_torch_on_finite_values_and_keeps_nan_payloads():
    rs = np.random.RandomState(1)
    x = np.concatenate([SPECIAL_BITS, rs.randint(0, 2 ** 32, 8192, dtype=np.uint64).astype(np.uint32)])
    src = torch.from_numpy(x.view(np.float32).copy())
    got = native.cast_f32_to_bf16(src).view(torch.int16).numpy()
    torch_bits = src.to(torch.bfloat16).view(torch.int16).numpy()
    nan = np.isnan(x.view(np.float32))
    np.testing.assert_array_equal(got[~nan], torch_bits[~nan])
    # NaNs: the sign and the payload's top bits kept, quieted
    nan_in = x[nan]
    np.testing.assert_array_equal(got[nan].view(np.uint16), ((nan_in >> 16) | 0x0040).astype(np.uint16))
    assert np.isnan((got[nan].view(np.uint16).astype(np.uint32) << 16).view(np.float32)).all()


def test_cast_writes_into_out_and_refuses_other_dtypes():
    src = torch.randn(3, 7)
    out = torch.empty(3, 7, dtype=torch.bfloat16)
    assert native.cast_f32_to_bf16(src, out=out).data_ptr() == out.data_ptr()
    assert torch.equal(out, src.to(torch.bfloat16))
    with pytest.raises(TypeError):
        native.cast_f32_to_bf16(src.double())


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_a_failed_build_raises(tmp_path, cxx):
    with pytest.raises(RuntimeError, match="native gather"):
        native.build(cxx=cxx, build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_the_build_lands_in_the_build_dir(tmp_path):
    path = native.build(build_dir=tmp_path)
    assert path.parent == tmp_path and path.name.startswith("_gather-") and path.exists()
    assert native.build(build_dir=tmp_path) == path  # built once


def test_six_processes_building_at_once_share_one_library(tmp_path):
    outcomes = race("port", 6, tmp_path)
    assert outcomes == ["ok"] * 6, outcomes
    left = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len([n for n in left if n.startswith("_gather-") and n.endswith(".so")]) == 1, left
    assert not [n for n in left if n.endswith(".tmp")], left


def _loader_args(d, qpt="svqa_train_questions.pt"):
    return dict(question_pt=f"{d}/{qpt}", vocab_json=f"{d}/svqa_vocab.json",
                appearance_feat=f"{d}/svqa_appearance_feat.h5", motion_feat=f"{d}/svqa_motion_feat.h5",
                batch_size=7, shuffle=True, seed=3)


@pytest.mark.parametrize("transfer_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_workers", [1, 4])
def test_loader_batches_equal_the_jax_loaders_through_the_native_gather(synth_dir, monkeypatch, num_workers,
                                                                         transfer_dtype):
    d = synth_dir["dir"]
    jax_loader = JaxLoader(**_loader_args(d), num_workers=num_workers, transfer_dtype=transfer_dtype)
    want = list(jax_loader)
    jax_loader.close()

    calls = []
    real = native.gather_rows

    def counted(src, rows, out=None, n_threads=None):
        calls.append(n_threads)
        return real(src, rows, out=out, n_threads=n_threads)

    def no_index_select(*a, **k):
        raise AssertionError("the loader gathered with torch.index_select")

    monkeypatch.setattr(native, "gather_rows", counted)
    monkeypatch.setattr(torch, "index_select", no_index_select)
    loader = VideoQADataLoader(**_loader_args(d), num_workers=num_workers, transfer_dtype=transfer_dtype)
    assert loader.app_store.n_threads == loader.gather_threads == num_workers
    got = list(loader)
    loader.close()
    assert len(got) == len(want) and calls and set(calls) == {num_workers}
    for a, b in zip(got, want):
        for name in ("appearance_feat", "motion_feat"):
            np.testing.assert_array_equal(_bits(getattr(a, name)), _bits(getattr(b, name)))
        np.testing.assert_array_equal(a.question, b.question)
        np.testing.assert_array_equal(a.answer, b.answer)
        np.testing.assert_array_equal(a.valid, b.valid)


@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_a_file_backed_store_casts_and_gathers_natively(synth_dir, store_dtype):
    path = synth_dir["appearance"]
    on_disk = FeatureStore(path, "resnet_features", cache_gb=0.0, store_dtype=store_dtype, n_threads=2)
    cached = FeatureStore(path, "resnet_features", store_dtype=store_dtype, n_threads=3)
    assert not on_disk.cached and cached.cached
    rows = np.random.RandomState(2).randint(0, on_disk.shape[0], 40)
    np.testing.assert_array_equal(_bits(on_disk.gather(rows)), _bits(cached.gather(rows)))
    np.testing.assert_array_equal(_bits(cached.gather(rows, n_threads=1)), _bits(cached.gather(rows)))
    on_disk.close()
