"""Kernel 9, the fp32 recurrent weight gradient of both directions (``ops/whh_grad_kernel.py::whh_grad_f32``), on the CPU.

Its plain version is the two products the BiLSTM's backward ran before it
(``recurrent_weight_grads``), bit for bit, and the wrapper runs it on CPU
tensors. The CUDA body runs here against the stand-in library of
``tests/test_torch_kernel_entries.py``: the contract it checks (shapes,
dtypes, contiguity, alignment), its scratch (hprev's TF32 halves and the
splits' partial tiles), one launch a call, and ``lstm.tc_f32_whh_rows``
counting the rows it sums; it takes widths that the other kernels refuse.
The plan splits K so that the units fill the card at the train cells'
shapes. The routing: the train step's backward calls the wrapper once a
trainable BiLSTM, the appearance one and both question ones, in fp32 and
under bf16 streaming (its operands are fp32 there too), and never on the
plain path; there the op runs the CUDA body under the stand-in and returns
the plain version's gradients, so the step goes on with the gradients of
the products before, bit for bit. Kernel 9's ``__global__`` names are read
by no kernel's roofline, and the A/B tool's kernel 9 variants find the
lines they change in the source.
"""

import importlib
import pkgutil
import re

import pytest
import torch

from dualvgr_tpu_torch import train_lib
from dualvgr_tpu_torch.bench import proj_kernel_ab
from dualvgr_tpu_torch.models.dualvgr import kernel_dim_limits
from dualvgr_tpu_torch.ops import COUNTED_KERNELS, _build, lstm_train, whh_grad_kernel
from dualvgr_tpu_torch.ops.lstm_kernel import bilstm_recurrence_reference
from dualvgr_tpu_torch.parallel.dryrun import TINY
from dualvgr_tpu_torch.utils import trace

from test_torch_kernel_entries import stand_in  # noqa: F401 (a fixture)
from test_torch_proj_f32 import _batch, _model

# (T, R, H): R odd, under one k-block, one past it, T 1, H 1, the question
# and appearance BiLSTMs' H 384 at small R
SHAPES = [(5, 7, 8), (3, 37, 50), (1, 33, 4), (1, 1, 1), (24, 3, 384), (16, 6, 384)]


def _inputs(t, r, h, seed=0):
    gen = torch.Generator().manual_seed(seed)
    hprev = torch.tanh(torch.randn(t, r, 2 * h, generator=gen))
    dxf, dxb = (torch.randn(t, r, 4 * h, generator=gen) * 1e-3 for _ in range(2))
    return hprev, dxf, dxb


def _products_before(hprev, dxf, dxb):
    """``recurrent_weight_grads`` before kernel 9: one plain product a
    direction over ``(T*R, H)^T @ (T*R, 4H)``."""
    hidden, g = hprev.shape[-1] // 2, dxf.shape[-1]
    dwf = hprev[..., :hidden].reshape(-1, hidden).t() @ dxf.reshape(-1, g)
    dwb = hprev[..., hidden:].reshape(-1, hidden).t() @ dxb.reshape(-1, g)
    return dwf, dwb


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.spans(), trace.counters()
    yield
    trace.disable()
    trace.spans(), trace.counters()


@pytest.mark.parametrize("shape", SHAPES, ids=[f"T{s[0]}-R{s[1]}-H{s[2]}" for s in SHAPES])
def test_plain_version_is_the_pair_of_products_it_replaces(shape):
    """Bit for bit the backward's two products before kernel 9, and through
    ``recurrent_weight_grads``; in fp64 the contract: both operands in
    kernel time, as they lie."""
    t, r, h = shape
    args = _inputs(*shape)
    got = whh_grad_kernel.whh_grad_f32_reference(*args)
    assert all(a.dtype == torch.float32 and a.shape == (h, 4 * h) for a in got)
    before = _products_before(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, before))
    assert all(torch.equal(a, b) for a, b in zip(lstm_train.recurrent_weight_grads(*args), before))
    h64, f64, b64 = (a.double() for a in args)
    want_f = sum(h64[s, :, :h].t() @ f64[s] for s in range(t))
    want_b = sum(h64[s, :, h:].t() @ b64[s] for s in range(t))
    for a, w in zip(got, (want_f, want_b)):
        torch.testing.assert_close(a.double(), w, rtol=1e-5, atol=1e-5 * w.abs().max().item())


def test_the_wrapper_runs_the_plain_version_on_cpu_and_refuses_grad():
    args = _inputs(5, 7, 8)
    n0 = whh_grad_kernel.whh_grad_f32.launches
    got = whh_grad_kernel.whh_grad_f32(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, _products_before(*args)))
    assert whh_grad_kernel.whh_grad_f32.launches == n0
    for i in range(3):
        grad_args = list(args)
        grad_args[i] = grad_args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="autograd"):
            whh_grad_kernel.whh_grad_f32(*grad_args)
        with torch.no_grad():
            whh_grad_kernel.whh_grad_f32(*grad_args)


def test_the_op_is_the_plain_version_on_cpu():
    args = _inputs(3, 37, 50)
    got = torch.ops.dualvgr_torch.whh_grad_f32(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, _products_before(*args)))


@pytest.fixture
def cuda_body(stand_in, monkeypatch):
    """The CUDA body on CPU tensors: the stand-in library, a card of 132
    SMs; returns the stand-in's calls."""
    monkeypatch.setattr(whh_grad_kernel, "sm_count", lambda dev: 132)
    return stand_in[0]


def test_the_cuda_body_keeps_the_contract(cuda_body):
    calls = cuda_body
    hprev, dxf, dxb = _inputs(5, 7, 8)
    n0 = whh_grad_kernel.whh_grad_f32.launches
    trace.enable()
    dw_f, dw_b = whh_grad_kernel._whh_cuda(hprev, dxf, dxb)
    trace.disable()
    assert calls == ["whh_grad_f32_launch"] and whh_grad_kernel.whh_grad_f32.launches == n0 + 1
    assert trace.counters() == {"lstm.tc_f32_whh_rows": 5 * 7}
    assert dw_f.shape == dw_b.shape == (8, 32) and dw_f.dtype == dw_b.dtype == torch.float32
    refusals = [
        ((hprev.to(torch.bfloat16), dxf, dxb), TypeError, "dtype"),
        ((hprev, dxf.to(torch.bfloat16), dxb), TypeError, "dtype"),
        ((hprev, dxf, dxb[:, :, :28].contiguous()), ValueError, "shape"),
        ((hprev, dxf, dxb[:4]), ValueError, "shape"),
        ((hprev[..., :15].contiguous(), dxf, dxb), ValueError, r"\(T, R, 2H\)"),
        ((hprev[0], dxf, dxb), ValueError, r"\(T, R, 2H\)"),
        ((hprev.transpose(0, 1).contiguous().transpose(0, 1), dxf, dxb), ValueError, "contiguous"),
        ((hprev, dxf.transpose(0, 1).contiguous().transpose(0, 1), dxb), ValueError, "contiguous"),
        ((torch.zeros(5 * 7 * 16 + 1)[1:].view(5, 7, 16), dxf, dxb), ValueError, "aligned"),
        ((hprev, dxf, torch.zeros(5 * 7 * 32 + 1)[1:].view(5, 7, 32)), ValueError, "aligned"),
    ]
    for args, err, match in refusals:
        with pytest.raises(err, match=match):
            whh_grad_kernel._whh_cuda(*args)
    assert calls == ["whh_grad_f32_launch"] and whh_grad_kernel.whh_grad_f32.launches == n0 + 1


@pytest.mark.parametrize("r", [1, 5, 32, 33])
def test_the_cuda_body_makes_its_scratch_and_tells_the_entry(cuda_body, monkeypatch, r):
    """The scratch holds both TF32 halves of hprev, (2H, T, R_pad) each,
    R_pad = R rounded up to 4, and a 128 x 128 partial tile for each of the
    plan's splits of each output tile; the entry is told R_pad and the
    splits."""
    made, seen = [], []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: made.append(tuple(shape)) or real_empty(shape, **kw))
    monkeypatch.setattr(whh_grad_kernel, "launch", lambda wrapper, entry, dev, *args: seen.append(args))
    t, h = 3, 200  # 2 x 7 x 2 = 28 output tiles
    whh_grad_kernel._whh_cuda(*_inputs(t, r, h))
    *dims, r_pad, splits = seen[0][-5:]
    assert dims == [r, t, h] and r_pad % 4 == 0 and r <= r_pad < r + 4
    assert splits == whh_grad_kernel.whh_grad_plan(r, t, h, 132) and 1 <= splits <= t * -(-r // 32)
    assert made[:2] == [(2, 2 * h, t, r_pad), (splits * 28, 128, 128)]
    whh_grad_kernel._whh_cuda(*_inputs(t, r, h), splits=1)
    assert seen[1][-1] == 1 and made[5] == (28, 128, 128)


@pytest.mark.parametrize("hidden", [1, 3, 6, 385])
def test_kernel_9_takes_widths_the_other_kernels_refuse(cuda_body, hidden):
    """No width limit of its own: an H that is no multiple of 4 (which
    kernels 1, 3 and 4 refuse) launches."""
    whh_grad_kernel._whh_cuda(*_inputs(2, 3, hidden))
    assert cuda_body == ["whh_grad_f32_launch"]
    assert not any("recurrent" in msg for msg in kernel_dim_limits(module_dim=2 * hidden))


# (R, T) of each train cell's appearance BiLSTM (batch 256 x 16, 8, 20
# clips; 16 frames) and of its question BiLSTMs (256 questions of 24, 24, 40)
CELLS = {"msrvtt-qa": ((4096, 16), (256, 24)), "msvd-qa": ((2048, 16), (256, 24)),
         "svqa": ((5120, 16), (256, 40))}


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_plan_fills_the_card_at_the_cells_shapes(cell):
    """On the H100's 132 SMs, H 384 (72 output tiles): the appearance
    BiLSTM's K in 11 splits, 792 units, 6 full waves; the question
    BiLSTMs' in at most 11, no wave under half full; at most 1,024 splits
    and none without a k-block."""
    (r, t), (qr, qt) = CELLS[cell]
    assert whh_grad_kernel.tiles(384) == 72
    assert whh_grad_kernel.whh_grad_plan(r, t, 384, 132) == 11
    splits = whh_grad_kernel.whh_grad_plan(qr, qt, 384, 132)
    assert 1 < splits <= 11 and (72 * splits) % 132 >= 66
    for shape in ((1, 1, 1), (5, 7, 8), (33, 1, 4), (100000, 1, 1)):
        splits = whh_grad_kernel.whh_grad_plan(*shape, 132)
        assert 1 <= splits <= min(whh_grad_kernel.MAX_SPLITS, shape[1] * -(-shape[0] // 32))


def test_the_plan_splits_nothing_where_the_tiles_fill_whole_waves():
    """2,048 tiles on 128 SMs are 16 full waves: no split; on 132 SMs the
    last of 16 waves is half empty, and 5 splits (78 waves, the last 58%
    full) take less."""
    assert whh_grad_kernel.tiles(2048) == 2048
    assert whh_grad_kernel.whh_grad_plan(4096, 16, 2048, 128) == 1
    assert whh_grad_kernel.whh_grad_plan(4096, 16, 2048, 132) == 5


def test_the_plans_constants_are_the_sources():
    text = (_build.CSRC / "whh_grad_f32.cu").read_text()
    header = (_build.CSRC / "tma_gemm.cuh").read_text()
    assert "constexpr int kBM = 128, kBN = 128, kBK = kDgK;" in text
    assert whh_grad_kernel.TILE_M == whh_grad_kernel.TILE_N == 128
    assert f"constexpr int kDgK = {whh_grad_kernel.K_BLOCK}," in header
    assert f"constexpr int kMaxSplits = {whh_grad_kernel.MAX_SPLITS};" in text


def test_counted_kernels_end_with_kernel_9_and_the_table_declares_it():
    assert len(COUNTED_KERNELS) == 10 and COUNTED_KERNELS[-1] is whh_grad_kernel.whh_grad_f32
    assert sorted(_build.ENTRIES["whh_grad_f32.cu"]) == ["whh_grad_f32_launch", "whh_grad_f32_smem_bytes"]


def _global_names(source):
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      (_build.CSRC / source).read_text())


def test_no_rooflines_pattern_reads_kernel_9():
    """Kernel 9's kernels, as the profiler names them, match no reader's
    pattern of ``perfbench/roofline/`` (kernels 1-4, 7 and 8 keep reading
    their own)."""
    import perfbench.roofline as roofline

    names = _global_names("whh_grad_f32.cu")
    assert sorted(names) == ["hprev_split_kernel", "whh_grad_kernel", "whh_grad_reduce_kernel"]
    patterns = {m.name: importlib.import_module(f"perfbench.roofline.{m.name}").PATTERN
                for m in pkgutil.iter_modules(roofline.__path__)
                if hasattr(importlib.import_module(f"perfbench.roofline.{m.name}"), "PATTERN")}
    assert {"k7_input_proj_f32", "k8_wgrad_f32"} <= set(patterns)
    for name in names:
        for reader, pattern in patterns.items():
            assert not pattern.search(f"(anonymous namespace)::{name}(float const*, int)"), (name, reader)


@pytest.fixture
def routed(stand_in, monkeypatch):
    """Every call of the wrapper on CPU tensors runs the CUDA body under the
    stand-in and returns the plain version's gradients; returns the shapes
    of the hprev kernel 9 was called with."""
    seen = []
    plain = whh_grad_kernel.whh_grad_f32_reference

    def reference(hprev, dxf, dxb):
        seen.append((tuple(hprev.shape), tuple(dxf.shape), tuple(dxb.shape)))
        whh_grad_kernel._whh_cuda(hprev, dxf, dxb)
        return plain(hprev, dxf, dxb)

    monkeypatch.setattr(whh_grad_kernel, "sm_count", lambda dev: 132)
    monkeypatch.setattr(whh_grad_kernel, "whh_grad_f32_reference", reference)
    return seen


@pytest.mark.parametrize("use_kernels, compute_dtype, calls", [
    (True, "float32", 3), (False, "float32", 0), (True, "bfloat16", 3)])
def test_the_train_step_routes_the_recurrent_weight_gradient(routed, monkeypatch, use_kernels, compute_dtype,
                                                             calls):
    """One call a trainable BiLSTM and train step: the appearance one
    (hprev (F, B*C, 2H)) and the two question ones (hprev (L, B, 2H), L
    the padded question length), in fp32 and under bf16 streaming; none on
    the plain path. ``lstm.tc_f32_whh_rows`` counts their rows. The step's
    loss and gradients are those of the products before, bit for bit."""
    batch = _batch()
    model = _model(use_kernels=use_kernels, compute_dtype=compute_dtype)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 10), seed=3)
    n0 = whh_grad_kernel.whh_grad_f32.launches
    trace.enable()
    train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)
    trace.disable()
    b, c, f, _ = batch[0].shape
    tokens = batch[2].shape[1]
    h = TINY["module_dim"] // 2
    appearance = ((f, b * c, 2 * h), (f, b * c, 4 * h), (f, b * c, 4 * h))
    question = ((tokens, b, 2 * h), (tokens, b, 4 * h), (tokens, b, 4 * h))
    assert sorted(routed) == sorted([appearance] + [question] * 2 if calls else [])
    assert whh_grad_kernel.whh_grad_f32.launches == n0 + calls
    assert trace.counters().get("lstm.tc_f32_whh_rows", 0) == (b * c * f + 2 * b * tokens if calls else 0)
    if calls:
        runs = []
        for old in (False, True):
            if old:
                monkeypatch.setattr(lstm_train, "whh_grad_f32", _products_before)
            state.model.zero_grad()
            state.generator.manual_seed(11)
            loss = train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)["loss"]
            runs.append((loss, [p.grad.clone() for p in state.model.parameters()]))
        (loss_k9, grads_k9), (loss_old, grads_old) = runs
        assert torch.isfinite(loss_k9) and torch.equal(loss_k9, loss_old)
        assert all(torch.equal(a, b) for a, b in zip(grads_k9, grads_old))
        assert len(routed) == 2 * calls


@pytest.mark.parametrize("op", ["bilstm_trainable", "appearance_bilstm_train"])
def test_the_trainable_functions_gradients_are_unchanged_on_the_cpu(op):
    """``BiLSTMTrainable`` (masked) and ``AppearanceBiLSTMTrain``: every
    gradient as with the products before, bit for bit, and the recurrent
    weights' as autograd's of the plain recurrence."""
    gen = torch.Generator().manual_seed(2)
    t, r, h, d = 6, 5, 8, 12
    w_hh = [(torch.randn(h, 4 * h, generator=gen) * 0.2).requires_grad_() for _ in range(2)]
    if op == "bilstm_trainable":
        xs = [torch.randn(t, r, 4 * h, generator=gen).requires_grad_() for _ in range(2)]
        lens = torch.tensor([6, 1, 3, 5, 2])
        leaves = xs + w_hh

        def run():
            final, outs = lstm_train.bilstm_trainable(*xs, *w_hh, lens)
            return final.square().sum() + outs.square().sum()
    else:
        x = torch.tanh(torch.randn(r, t, d, generator=gen))
        w_ih = [(torch.randn(4 * h, d, generator=gen) * 0.2).requires_grad_() for _ in range(2)]
        bias = [(torch.randn(4 * h, generator=gen) * 0.1).requires_grad_() for _ in range(2)]
        leaves = w_ih + bias + w_hh

        def run():
            return lstm_train.appearance_bilstm_train(x, w_ih[0], bias[0], w_hh[0], w_ih[1], bias[1],
                                                      w_hh[1]).square().sum()

    grads = []
    for old in (False, True):
        with pytest.MonkeyPatch.context() as mp:
            if old:
                mp.setattr(lstm_train, "whh_grad_f32", _products_before)
            grads.append(torch.autograd.grad(run(), leaves))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    if op == "bilstm_trainable":
        final, outs = bilstm_recurrence_reference(*xs, *w_hh, lens, with_outputs=True)
        want = torch.autograd.grad(final.square().sum() + outs.square().sum(), w_hh)
        for a, b in zip(grads[0][2:], want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", list(proj_kernel_ab.K9_VARIANTS))
def test_the_ab_tools_kernel_9_variants_apply_to_the_source(name):
    """Each build variant of ``bench/proj_kernel_ab.py --kernel 9`` finds the
    lines it changes in ``csrc/whh_grad_f32.cu`` (the tool runs only on the
    card, so a renamed line would show only there)."""
    text = (_build.CSRC / proj_kernel_ab.K9_SOURCE).read_text()
    changes, _ = proj_kernel_ab.K9_VARIANTS[name]
    variant = proj_kernel_ab.apply_changes(text, changes, proj_kernel_ab.K9_SOURCE)
    assert (variant == text) == (not changes)
