"""Kernel 7, the fp32 projection of both directions (``ops/proj_kernel.py::input_proj_f32``), on the CPU.

Its plain version is the two ``input_proj`` products it replaces, bit for
bit, the backward direction time-reversed. The CUDA body runs here against
the stand-in library of ``tests/test_torch_kernel_entries.py``: the
contract it checks (shapes, dtypes, contiguity, alignment, the widths of
``f32_dim_limit``), one launch a call, and ``proj.tc_f32_rows`` counting
the rows it projects. The routings: on the kernel path in fp32 the
appearance encoder calls the wrapper once a forward, in training and in
eval, and no other BiLSTM does; the plain path and the bf16 path never
call it. There the op runs the CUDA body under the stand-in (a stub of the
launch) and returns the plain version's gates, so the forward goes on.
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model, train_lib
from dualvgr_tpu_torch.models import encoders
from dualvgr_tpu_torch.ops import COUNTED_KERNELS, lstm_train, proj_kernel
from dualvgr_tpu_torch.models.dualvgr import kernel_dim_limits
from dualvgr_tpu_torch.ops.lstm import LSTMParams, bilstm, time_major_input_proj
from dualvgr_tpu_torch.parallel.dryrun import TINY, tiny_batches
from dualvgr_tpu_torch.utils import trace

from test_torch_kernel_entries import stand_in  # noqa: F401 (a fixture)

SHAPES = [(4, 3, 16, 32), (5, 7, 24, 40), (1, 1, 4, 4), (3, 16, 72, 200)]


def _inputs(r, t, d, g, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.tanh(torch.randn(r, t, d, generator=gen))
    w_f, w_b = (torch.randn(g, d, generator=gen) * 0.2 for _ in range(2))
    b_f, b_b = (torch.randn(g, generator=gen) for _ in range(2))
    return x, w_f, b_f, w_b, b_b


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.spans(), trace.counters()
    yield
    trace.disable()
    trace.spans(), trace.counters()


@pytest.mark.parametrize("shape", SHAPES, ids=[f"R{s[0]}-T{s[1]}-D{s[2]}-G{s[3]}" for s in SHAPES])
def test_plain_version_is_the_input_proj_pair_it_replaces(shape):
    """Bit for bit the two baddbmm products of ``input_proj`` (and of the
    plain path's ``time_major_input_proj``, whose bias is b_ih + b_hh), the
    backward direction's step t at T-1-t."""
    x, w_f, b_f, w_b, b_b = _inputs(*shape)
    xf, xb = proj_kernel.input_proj_f32_reference(x, w_f, b_f, w_b, b_b)
    assert xf.dtype == xb.dtype == torch.float32 and xf.shape == xb.shape == (shape[1], shape[0], shape[3])
    assert torch.equal(xf, proj_kernel.input_proj(x, w_f, b_f))
    assert torch.equal(xb, proj_kernel.input_proj(x, w_b, b_b, reverse=True))
    half = b_b / 2
    params = LSTMParams(w_b, torch.zeros(shape[3], shape[3] // 4), half, b_b - half)
    assert torch.equal(xb, time_major_input_proj(x, params, reverse=True))
    for t in range(shape[1]):
        torch.testing.assert_close(xb[shape[1] - 1 - t], x[:, t] @ w_b.t() + b_b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(xf[t], x[:, t] @ w_f.t() + b_f, rtol=1e-5, atol=1e-5)


def test_the_wrapper_runs_the_plain_version_on_cpu_and_refuses_grad():
    x, w_f, b_f, w_b, b_b = _inputs(4, 3, 16, 32)
    n0 = proj_kernel.input_proj_f32.launches
    got = proj_kernel.input_proj_f32(x, w_f, b_f, w_b, b_b)
    want = proj_kernel.input_proj_f32_reference(x, w_f, b_f, w_b, b_b)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert proj_kernel.input_proj_f32.launches == n0
    with pytest.raises(RuntimeError, match="autograd"):
        proj_kernel.input_proj_f32(x, w_f.requires_grad_(), b_f, w_b, b_b)
    with torch.no_grad():
        proj_kernel.input_proj_f32(x, w_f, b_f, w_b, b_b)


@pytest.mark.parametrize("d,g,ok", [(2048, 1536, True), (4, 4, True), (2050, 1536, False), (2048, 1538, False),
                                    (0, 8, False)])
def test_the_kernels_widths(d, g, ok):
    """``f32_dim_limit`` words the widths; ``kernel_dim_limits`` refuses an
    fp32 model whose appearance features break them (its 4H = 4 *
    (module_dim // 2) is always % 4), and leaves a bf16 one to kernel 6's
    limit."""
    assert (proj_kernel.f32_dim_limit(d, g) is None) == ok
    if d > 0 and g % 4 == 0:
        refused = [m for m in kernel_dim_limits(vision_dim=d) if "fp32 projection" in m]
        assert len(refused) == (0 if ok else 1)
        assert not any("fp32 projection" in m for m in kernel_dim_limits(vision_dim=d, compute_dtype="bfloat16"))


def test_the_cuda_body_keeps_the_contract(stand_in):
    calls, _ = stand_in
    x, w_f, b_f, w_b, b_b = _inputs(5, 7, 24, 40)
    n0 = proj_kernel.input_proj_f32.launches
    trace.enable()
    xf, xb = proj_kernel._f32_cuda(x, w_f, b_f, w_b, b_b)
    trace.disable()
    assert calls == ["input_proj_f32_launch"] and proj_kernel.input_proj_f32.launches == n0 + 1
    assert trace.counters() == {"proj.tc_f32_rows": 5 * 7}
    assert xf.shape == xb.shape == (7, 5, 40) and xf.dtype == xb.dtype == torch.float32
    refusals = [
        ((torch.zeros(5, 7, 22), w_f[:, :22].contiguous(), b_f, w_b[:, :22].contiguous(), b_b), ValueError, "% 4"),
        ((x, w_f[:38].contiguous(), b_f[:38], w_b[:38].contiguous(), b_b[:38]), ValueError, "% 4"),
        ((x.to(torch.bfloat16), w_f, b_f, w_b, b_b), TypeError, "dtype"),
        ((x[:, :, :20].contiguous(), w_f, b_f, w_b, b_b), ValueError, "shape"),
        ((x.transpose(0, 1).contiguous().transpose(0, 1), w_f, b_f, w_b, b_b), ValueError, "contiguous"),
        ((torch.zeros(5 * 7 * 24 + 1)[1:].view(5, 7, 24), w_f, b_f, w_b, b_b), ValueError, "aligned"),
        ((x, w_f, torch.zeros(41)[1:], w_b, b_b), ValueError, "aligned"),
        ((x, w_f, b_f, w_b, b_b[:39]), ValueError, "shape"),
        ((x[0], w_f, b_f, w_b, b_b), ValueError, r"\(R, T, D\)"),
    ]
    for args, err, match in refusals:
        with pytest.raises(err, match=match):
            proj_kernel._f32_cuda(*args)
    assert calls == ["input_proj_f32_launch"] and proj_kernel.input_proj_f32.launches == n0 + 1


def test_counted_kernels_end_with_kernel_7():
    # kernel 7, then kernels 8 and 9 (tests/test_torch_wgrad_f32.py, test_torch_whh_grad_f32.py) after it
    assert len(COUNTED_KERNELS) == 10 and COUNTED_KERNELS[7] is proj_kernel.input_proj_f32
    assert [k.__name__ for k in COUNTED_KERNELS[4:7]] == ["input_proj_one", "input_proj_both", "tanh_to_bf16"]


@pytest.fixture
def routed(stand_in, monkeypatch):
    """Every call of the op on CPU tensors runs the CUDA body under the
    stand-in and returns the plain version's gates; returns the shapes of
    the x it was called with."""
    seen = []

    def op(x, w_f, b_f, w_b, b_b):
        seen.append(tuple(x.shape))
        proj_kernel._f32_cuda(x, w_f, b_f, w_b, b_b)
        return proj_kernel.input_proj_f32_reference(x, w_f, b_f, w_b, b_b)

    monkeypatch.setattr(proj_kernel, "_f32_op", op)
    return seen


def _old_routing(monkeypatch):
    """The routings as before kernel 7: the two plain products in training,
    the BiLSTM's own eval routing (``time_major_input_proj`` and kernel 1)
    in eval."""
    monkeypatch.setattr(lstm_train, "input_proj_f32", proj_kernel.input_proj_f32_reference)
    monkeypatch.setattr(encoders, "appearance_final_f32", lambda fwd, bwd, x: bilstm(
        fwd, bwd, x, with_outputs=False, use_kernel=True, drop_input_grad=True)[1])


def _model(**kw):
    return build_model(device="cpu", seed=0, **TINY, **kw)


def _batch(seed=5):
    return tuple(torch.from_numpy(a) for a in tiny_batches(1, seed=seed)[0])


@pytest.mark.parametrize("use_kernels, compute_dtype, calls", [
    (True, "float32", 1), (False, "float32", 0), (True, "bfloat16", 0)])
def test_the_train_step_routes_the_appearance_projection(routed, monkeypatch, use_kernels, compute_dtype, calls):
    """One call a train step, from the appearance encoder (x of width
    vision_dim, R = batch * clips rows), none from the question encoders;
    none on the plain path or under bf16 streaming. The step's loss and
    gradients are those of the routing before, bit for bit."""
    batch = _batch()
    state = train_lib.create_train_state(
        _model(use_kernels=use_kernels, compute_dtype=compute_dtype), train_lib.make_optimizer(1e-3, 10), seed=3)
    n0 = proj_kernel.input_proj_f32.launches
    trace.enable()
    got = train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)["loss"].item()
    trace.disable()
    b, c, f, d = batch[0].shape
    assert routed == [(b * c, f, d)] * calls
    assert proj_kernel.input_proj_f32.launches == n0 + calls
    assert trace.counters().get("proj.tc_f32_rows", 0) == calls * b * c * f
    if calls:
        runs = []
        for old in (False, True):
            if old:
                _old_routing(monkeypatch)
            state.model.zero_grad()
            state.generator.manual_seed(11)
            loss = train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)["loss"]
            runs.append((loss, [p.grad.clone() for p in state.model.parameters()]))
        (loss_k7, grads_k7), (loss_old, grads_old) = runs
        assert np.isfinite(got) and torch.equal(loss_k7, loss_old)
        assert all(torch.equal(a, b) for a, b in zip(grads_k7, grads_old))
        assert len(routed) == 2 * calls


@pytest.mark.parametrize("use_kernels, compute_dtype, calls", [
    (True, "float32", 1), (False, "float32", 0), (True, "bfloat16", 0)])
def test_the_eval_forward_routes_the_appearance_projection(routed, monkeypatch, use_kernels, compute_dtype, calls):
    """One call an eval forward in fp32 on the kernel path, none on the
    plain path or under bf16 (kernel 6 there); the logits are those of the
    routing before, bit for bit."""
    app, mot, q, qlen = _batch()[:4]
    model = _model(use_kernels=use_kernels, compute_dtype=compute_dtype)
    with torch.no_grad():
        got = model(app, mot, q, qlen).logits
        b, c, f, d = app.shape
        assert routed == [(b * c, f, d)] * calls
        if calls:
            _old_routing(monkeypatch)
            assert torch.equal(got, model(app, mot, q, qlen).logits)
            assert len(routed) == calls


def test_a_tensor_parallel_projection_keeps_the_eval_routing_off(routed):
    """A BiLSTM whose projection tensor parallelism replaced
    (``input_proj`` set) keeps it: the eval forward does not call kernel 7."""
    app, mot, q, qlen = _batch()[:4]
    model = _model()
    appearance = next(m for m in model.modules() if type(m).__name__ == "AppearanceEncoder")
    appearance.encoder.input_proj = lambda x, params, *, reverse=False, stream_dtype=None: time_major_input_proj(
        x, params, reverse=reverse, stream_dtype=stream_dtype)
    with torch.no_grad():
        model(app, mot, q, qlen)
    assert routed == []
