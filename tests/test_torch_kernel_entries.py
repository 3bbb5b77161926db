"""The kernel layer's declarations and its one launch path, on the CPU.

``ops/_build.py::ENTRIES`` declares the argument and return types of every
``extern "C"`` entry of ``csrc/*.cu`` once; a wrong one would only show on
the card, as a crash. Each entry is held here against the parameter list
parsed from its source. Every wrapper's CUDA body and every plan helper
then runs on CPU tensors against a stand-in library that takes each call
only with the declared number and kinds of arguments, so an entry a
wrapper calls but the table lacks, or a call that disagrees with its
declaration, fails here. The device rule (``ops/launch.py::dispatch``):
a tensor on neither the CPU nor a CUDA device raises ``ValueError`` naming
the wrapper.
"""

import contextlib
import ctypes
import re
import types

import pytest
import torch

from dualvgr_tpu_torch.ops import (
    COUNTED_KERNELS, _build, gat_kernel, lstm_kernel, lstm_train_kernel, proj_kernel, whh_grad_kernel,
)

C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}
TABLE = [(source, name) for source, entries in _build.ENTRIES.items() for name in entries]


def source_entries(source):
    """``{name: (return type, [argument types])}`` of the ``extern "C"``
    entries of ``csrc/<source>``, parsed from their C signatures."""
    out = {}
    text = (_build.CSRC / source).read_text()
    for ret, name, params in re.findall(r'extern "C" (\w+) (\w+)\(([^)]*)\)', text):
        args = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            ctype = re.sub(r"\s+", " ", param.rsplit(None, 1)[0].removeprefix("const ")).replace(" *", "*")
            args.append(C_TYPES[ctype])
        out[name] = (C_TYPES[ret], args)
    return out


@pytest.mark.parametrize("source,name", TABLE, ids=[name for _, name in TABLE])
def test_declaration_is_the_sources_signature(source, name):
    restype, argtypes = _build.ENTRIES[source][name]
    assert (restype, list(argtypes)) == source_entries(source)[name]


def test_the_table_declares_every_entry_of_every_source():
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == sorted(_build.ENTRIES)
    for source, entries in _build.ENTRIES.items():
        assert sorted(entries) == sorted(source_entries(source)), source


class StandInLibrary:
    """A library of ``source`` whose entries check each call against the
    table, record it in ``calls`` and return ``results[suffix]``."""

    def __init__(self, source, calls, results):
        self.source, self.calls, self.results = source, calls, results

    def __getattr__(self, name):
        restype, argtypes = _build.ENTRIES[self.source][name]

        def entry(*args):
            assert len(args) == len(argtypes), (name, args)
            for arg, ctype in zip(args, argtypes):
                # a pointer is an address or None (null); a number is a Python int
                assert type(arg) is int or (arg is None and ctype is ctypes.c_void_p), (name, arg, ctype)
            self.calls.append(name)
            return next(v for k, v in self.results.items() if name.endswith(k))

        return entry


@pytest.fixture
def stand_in(monkeypatch):
    """Route every entry the kernel layer asks ``_build`` for to a
    stand-in library on the CPU; returns the list of calls and the
    results by suffix (launches succeed, the card keeps 7 clusters)."""
    calls, results = [], {"_launch": 0, "_active_clusters": 7, "_smem_bytes": 4096}
    monkeypatch.setattr(_build, "load", lambda source: StandInLibrary(source, calls, results))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(lstm_kernel, "_active", {})
    monkeypatch.setattr(gat_kernel, "_resident", {})
    return calls, results


T, R, H = 3, 5, 8
B, N, D, HEADS = 2, 4, 16, 4


def _lstm_args(gen):
    x = [torch.randn(T, R, 4 * H, generator=gen) for _ in range(2)]
    w = [torch.randn(H, 4 * H, generator=gen) for _ in range(2)]
    return x, w, torch.tensor([3, 1, 2, 3, 2])


def call_recurrence(gen):
    x, w, lens = _lstm_args(gen)
    lstm_kernel._recurrence_cuda(*x, *w, lens, True)


def call_train_fwd(gen):
    x, w, lens = _lstm_args(gen)
    lstm_train_kernel._fwd_cuda(*x, *w, lens, with_outputs=True)


def call_train_bwd(gen):
    _, w, lens = _lstm_args(gen)
    acts = torch.rand(2, T, R, 4 * H, generator=gen)
    cprev, douts = torch.randn(T, R, 2 * H, generator=gen), torch.randn(R, T, 2 * H, generator=gen)
    lstm_train_kernel._bwd_cuda(acts, *w, lens, cprev, torch.randn(R, 2 * H, generator=gen), douts)


def call_gat_cycle(gen):
    hd = D // HEADS
    h = torch.randn(B, N, D, generator=gen)
    scores = torch.rand(B, N, 1, generator=gen).expand(B, N, hd)
    shapes = ((D, D), (D,), (HEADS, 2 * hd), (HEADS,)) * 2 + ((D, D), (D,), (D, 1))
    gat_kernel._cycle_cuda(h, scores, *(torch.randn(*s, generator=gen) for s in shapes))


def _proj_args(gen):
    return torch.randn(R, T, D, generator=gen), torch.randn(4 * H, D, generator=gen), torch.randn(4 * H, generator=gen)


def call_tanh(gen):
    proj_kernel._tanh_cuda(torch.randn(R, T, D, generator=gen))


def call_proj_one(gen):
    proj_kernel._one_cuda(*_proj_args(gen), reverse=True)


def call_proj_both(gen):
    x, w, b = _proj_args(gen)
    proj_kernel._both_cuda(x, w, b, w, b, True)


def call_proj_f32(gen):
    x, w, b = _proj_args(gen)
    proj_kernel._f32_cuda(x, w, b, w, b)


def call_wgrad_f32(gen):
    x, _, _ = _proj_args(gen)
    dx = [torch.randn(T, R, 4 * H, generator=gen) for _ in range(2)]
    proj_kernel._wgrad_cuda(x, *dx)


def call_whh_grad_f32(gen):
    hprev = torch.randn(T, R, 2 * H, generator=gen)
    dx = [torch.randn(T, R, 4 * H, generator=gen) for _ in range(2)]
    whh_grad_kernel._whh_cuda(hprev, *dx, splits=2)


# (what runs, the wrapper that counts its launch or None, the entries it calls in order)
CALLERS = {
    "bilstm_recurrence": (call_recurrence, lstm_kernel.bilstm_recurrence,
                          ["bilstm_recurrence_active_clusters", "bilstm_recurrence_launch"]),
    "bilstm_train_fwd": (call_train_fwd, lstm_train_kernel.bilstm_train_fwd,
                         ["bilstm_train_fwd_active_clusters", "bilstm_train_fwd_launch"]),
    "bilstm_train_bwd": (call_train_bwd, lstm_train_kernel.bilstm_train_bwd,
                         ["bilstm_train_bwd_active_clusters", "bilstm_train_bwd_launch"]),
    # one resident-cluster query per cluster size D = 16 takes (1, 2, 4 CTAs)
    "gat_cycle": (call_gat_cycle, gat_kernel.gat_cycle, ["gat_cycle_active_clusters"] * 3 + ["gat_cycle_launch"]),
    "tanh_to_bf16": (call_tanh, proj_kernel.tanh_to_bf16, ["tanh_to_bf16_launch"]),
    # on a CPU x the tanh pass before the product runs its plain version
    "input_proj_one": (call_proj_one, proj_kernel.input_proj_one, ["input_proj_launch"]),
    "input_proj_both": (call_proj_both, proj_kernel.input_proj_both, ["input_proj_launch"]),
    "input_proj_f32": (call_proj_f32, proj_kernel.input_proj_f32, ["input_proj_f32_launch"]),
    "input_proj_f32_wgrad": (call_wgrad_f32, proj_kernel.input_proj_f32_wgrad, ["wgrad_f32_launch"]),
    "whh_grad_f32": (call_whh_grad_f32, whh_grad_kernel.whh_grad_f32, ["whh_grad_f32_launch"]),
    "bilstm_recurrence_smem": (lambda gen: lstm_kernel.library_smem_bytes("bilstm_recurrence", H), None,
                               ["bilstm_recurrence_smem_bytes"]),
    "bilstm_train_fwd_smem": (lambda gen: lstm_kernel.library_smem_bytes("bilstm_train_fwd", H), None,
                              ["bilstm_train_fwd_smem_bytes"]),
    "bilstm_train_bwd_smem": (lambda gen: lstm_kernel.library_smem_bytes("bilstm_train_bwd", H), None,
                              ["bilstm_train_bwd_smem_bytes"]),
    "gat_cycle_smem": (lambda gen: gat_kernel.library_smem_bytes(B, N, D, HEADS, gat_kernel.cycle_plan(B, N, D, HEADS)),
                       None, ["gat_cycle_smem_bytes"]),
    "input_proj_smem": (lambda gen: proj_kernel.library_smem_bytes(), None, ["input_proj_smem_bytes"]),
    "input_proj_f32_smem": (lambda gen: proj_kernel.f32_library_smem_bytes(), None,
                            ["input_proj_f32_smem_bytes"]),
    "wgrad_f32_smem": (lambda gen: proj_kernel.f32_wgrad_library_smem_bytes(), None, ["wgrad_f32_smem_bytes"]),
    "whh_grad_f32_smem": (lambda gen: whh_grad_kernel.library_smem_bytes(), None, ["whh_grad_f32_smem_bytes"]),
}
LAUNCHERS = [name for name, (_, wrapper, _) in CALLERS.items() if wrapper is not None]


@pytest.mark.parametrize("caller", list(CALLERS))
def test_every_call_is_declared(stand_in, caller):
    """The CUDA body or plan helper calls only entries of the table, each
    with the declared arguments, and a launch counts once."""
    calls, _ = stand_in
    run, wrapper, want = CALLERS[caller]
    before = wrapper.launches if wrapper is not None else None
    run(torch.Generator().manual_seed(0))
    assert calls == want
    if wrapper is not None:
        assert wrapper.launches == before + 1


def test_the_wrappers_and_plan_helpers_call_every_entry():
    assert {e for _, _, want in CALLERS.values() for e in want} == {name for _, name in TABLE}
    assert {wrapper for _, wrapper, _ in CALLERS.values() if wrapper is not None} == set(COUNTED_KERNELS)


@pytest.mark.parametrize("caller", LAUNCHERS)
def test_a_failed_launch_raises_and_counts_nothing(stand_in, caller):
    _, results = stand_in
    results["_launch"] = 700  # cudaErrorIllegalAddress
    run, wrapper, want = CALLERS[caller]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match=f"{want[-1].removesuffix('_launch')} launch failed: cudaError 700"):
        run(torch.Generator().manual_seed(0))
    assert wrapper.launches == before


def _meta(*shape):
    return torch.empty(shape, device="meta")


META_CALLS = {
    "bilstm_recurrence": lambda: lstm_kernel.bilstm_recurrence(
        _meta(T, R, 4 * H), _meta(T, R, 4 * H), _meta(H, 4 * H), _meta(H, 4 * H)),
    "gat_cycle": lambda: gat_kernel.gat_cycle(_meta(B, N, D), *(_meta(1) for _ in range(12))),
    "bilstm_train_fwd": lambda: lstm_train_kernel.bilstm_train_fwd(
        _meta(T, R, 4 * H), _meta(T, R, 4 * H), _meta(H, 4 * H), _meta(H, 4 * H)),
    "bilstm_train_bwd": lambda: lstm_train_kernel.bilstm_train_bwd(
        _meta(2, T, R, 4 * H), _meta(H, 4 * H), _meta(H, 4 * H), None, _meta(T, R, 2 * H), _meta(R, 2 * H)),
    "input_proj_one": lambda: proj_kernel.input_proj_one(_meta(R, T, D), _meta(4 * H, D), _meta(4 * H)),
    "input_proj_both": lambda: proj_kernel.input_proj_both(
        _meta(R, T, D), _meta(4 * H, D), _meta(4 * H), _meta(4 * H, D), _meta(4 * H)),
    "tanh_to_bf16": lambda: proj_kernel.tanh_to_bf16(_meta(R, T, D)),
    "input_proj_f32": lambda: proj_kernel.input_proj_f32(
        _meta(R, T, D), _meta(4 * H, D), _meta(4 * H), _meta(4 * H, D), _meta(4 * H)),
    "input_proj_f32_wgrad": lambda: proj_kernel.input_proj_f32_wgrad(
        _meta(R, T, D), _meta(T, R, 4 * H), _meta(T, R, 4 * H)),
    "whh_grad_f32": lambda: whh_grad_kernel.whh_grad_f32(
        _meta(T, R, 2 * H), _meta(T, R, 4 * H), _meta(T, R, 4 * H)),
}


@pytest.mark.parametrize("wrapper", [k.__name__ for k in COUNTED_KERNELS])
def test_a_wrapper_refuses_a_device_it_has_no_path_for(wrapper):
    with pytest.raises(ValueError, match=f"^{wrapper} runs on CPU or CUDA, not meta$"):
        META_CALLS[wrapper]()


def test_using_puts_a_library_in_place_and_restores_the_one_before(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})

    def library():
        return types.SimpleNamespace(**{name: lambda *a: 0 for name in _build.ENTRIES["input_proj.cu"]})

    variant, committed = library(), library()
    with _build.using("input_proj.cu", variant):
        assert _build.entry("tanh_to_bf16_launch") is variant.tanh_to_bf16_launch
        assert variant.tanh_to_bf16_launch.argtypes == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                                        ctypes.c_void_p]
    assert "input_proj.cu" not in _build._libs
    _build._libs["input_proj.cu"] = committed
    with _build.using("input_proj.cu", variant):
        assert _build.load("input_proj.cu") is variant
    assert _build.load("input_proj.cu") is committed
