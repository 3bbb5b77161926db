"""Kernel 8, the fp32 input weight gradient of both directions (``ops/proj_kernel.py::input_proj_f32_wgrad``), on the CPU.

Its plain version is the two products the appearance op's backward ran
before it, bit for bit: each direction's dgates (T, R, 4H), the backward's
flipped back to the sequence's time, transposed times x. The CUDA body
runs here against the stand-in library of
``tests/test_torch_kernel_entries.py``: the contract it checks (shapes,
dtypes, contiguity, alignment, the widths of ``f32_dim_limit``), one launch
a call, and ``proj.tc_f32_wgrad_rows`` counting the rows it sums. The
routing: the fp32 train step's backward calls the wrapper once a step,
from the appearance op, beside kernel 7 in its forward; the plain path and
the bf16 stream step never call it. There the op runs the CUDA body under
the stand-in and returns the plain version's gradients, so the step goes
on with the gradients of the routing before. The A/B tool's kernel 8
variants find the lines they change in the source.
"""

import pytest
import torch

from dualvgr_tpu_torch import train_lib
from dualvgr_tpu_torch.bench import proj_kernel_ab
from dualvgr_tpu_torch.ops import COUNTED_KERNELS, _build, lstm_train, proj_kernel
from dualvgr_tpu_torch.parallel.dryrun import TINY
from dualvgr_tpu_torch.utils import trace

from test_torch_kernel_entries import stand_in  # noqa: F401 (a fixture)
from test_torch_proj_f32 import _batch, _model

# (R, T, D, 4H): R odd, R not a multiple of 32, T 1, and the three train
# cells' (T, D, 4H), which all share T 16, D 2,048 and 4H 1,536, at small R
SHAPES = [(5, 7, 24, 40), (37, 3, 72, 200), (33, 1, 8, 4), (1, 1, 4, 4), (3, 16, 2048, 1536),
          (6, 16, 2048, 1536)]


def _inputs(r, t, d, g, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.tanh(torch.randn(r, t, d, generator=gen))
    dxf, dxb = (torch.randn(t, r, g, generator=gen) * 1e-3 for _ in range(2))
    return x, dxf, dxb


def _products_before(x, dxf, dxb):
    """``AppearanceBiLSTMTrain.backward``'s fp32 dW_ih before kernel 8."""
    r, t, d = x.shape
    xs = x.reshape(r * t, d)
    g = dxf.shape[-1]
    dwih_f = dxf.transpose(0, 1).reshape(r * t, g).t() @ xs
    dwih_b = dxb.flip(0).transpose(0, 1).reshape(r * t, g).t() @ xs
    return dwih_f, dwih_b


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.spans(), trace.counters()
    yield
    trace.disable()
    trace.spans(), trace.counters()


@pytest.mark.parametrize("shape", SHAPES, ids=[f"R{s[0]}-T{s[1]}-D{s[2]}-G{s[3]}" for s in SHAPES])
def test_plain_version_is_the_pair_of_products_it_replaces(shape):
    """Bit for bit the backward's two products before kernel 8; in fp64 the
    contract: the forward direction's step t with x at t, the backward's
    (kernel time) with x at T-1-t."""
    r, t, d, g = shape
    x, dxf, dxb = _inputs(*shape)
    got = proj_kernel.input_proj_f32_wgrad_reference(x, dxf, dxb)
    assert all(a.dtype == torch.float32 and a.shape == (g, d) for a in got)
    assert all(torch.equal(a, b) for a, b in zip(got, _products_before(x, dxf, dxb)))
    x64, f64, b64 = x.double(), dxf.double(), dxb.double()
    want_f = sum(f64[s].t() @ x64[:, s] for s in range(t))
    want_b = sum(b64[s].t() @ x64[:, t - 1 - s] for s in range(t))
    for a, w in zip(got, (want_f, want_b)):
        torch.testing.assert_close(a.double(), w, rtol=1e-5, atol=1e-5 * w.abs().max().item())


def test_the_wrapper_runs_the_plain_version_on_cpu_and_refuses_grad():
    x, dxf, dxb = _inputs(5, 7, 24, 40)
    n0 = proj_kernel.input_proj_f32_wgrad.launches
    got = proj_kernel.input_proj_f32_wgrad(x, dxf, dxb)
    assert all(torch.equal(a, b) for a, b in zip(got, proj_kernel.input_proj_f32_wgrad_reference(x, dxf, dxb)))
    assert proj_kernel.input_proj_f32_wgrad.launches == n0
    for i in range(3):
        args = [x, dxf, dxb]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="autograd"):
            proj_kernel.input_proj_f32_wgrad(*args)
        with torch.no_grad():
            proj_kernel.input_proj_f32_wgrad(*args)


def test_the_cuda_body_keeps_the_contract(stand_in):
    calls, _ = stand_in
    x, dxf, dxb = _inputs(5, 7, 24, 40)
    n0 = proj_kernel.input_proj_f32_wgrad.launches
    trace.enable()
    dw_f, dw_b = proj_kernel._wgrad_cuda(x, dxf, dxb)
    trace.disable()
    assert calls == ["wgrad_f32_launch"] and proj_kernel.input_proj_f32_wgrad.launches == n0 + 1
    assert trace.counters() == {"proj.tc_f32_wgrad_rows": 5 * 7}
    assert dw_f.shape == dw_b.shape == (40, 24) and dw_f.dtype == dw_b.dtype == torch.float32
    odd = torch.zeros(7, 5, 38)
    refusals = [
        ((torch.zeros(5, 7, 22), dxf, dxb), ValueError, "% 4"),
        ((x, odd, odd), ValueError, "% 4"),
        ((x.to(torch.bfloat16), dxf, dxb), TypeError, "dtype"),
        ((x, dxf.to(torch.bfloat16), dxb), TypeError, "dtype"),
        ((x, dxf, dxb[:, :4].contiguous()), ValueError, "shape"),
        ((x, dxf, dxb[:6]), ValueError, "shape"),
        ((x.transpose(0, 1).contiguous().transpose(0, 1), dxf, dxb), ValueError, "contiguous"),
        ((x, dxf.transpose(0, 1).contiguous().transpose(0, 1), dxb), ValueError, "contiguous"),
        ((torch.zeros(5 * 7 * 24 + 1)[1:].view(5, 7, 24), dxf, dxb), ValueError, "aligned"),
        ((x, dxf, torch.zeros(7 * 5 * 40 + 1)[1:].view(7, 5, 40)), ValueError, "aligned"),
        ((x[0], dxf, dxb), ValueError, r"\(R, T, D\)"),
    ]
    for args, err, match in refusals:
        with pytest.raises(err, match=match):
            proj_kernel._wgrad_cuda(*args)
    assert calls == ["wgrad_f32_launch"] and proj_kernel.input_proj_f32_wgrad.launches == n0 + 1


@pytest.mark.parametrize("r", [1, 5, 32, 33])
def test_the_cuda_body_pads_x_to_tmas_strides(stand_in, monkeypatch, r):
    """The scratch holds both TF32 halves of x, (D, T, R_pad) each, R_pad =
    R rounded up to 4, and the entry is told R_pad."""
    calls, _ = stand_in
    made, seen = [], []
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda shape, **kw: made.append(tuple(shape)) or real_empty(shape, **kw))
    monkeypatch.setattr(proj_kernel, "launch", lambda wrapper, entry, dev, *args: seen.append(args))
    proj_kernel._wgrad_cuda(*_inputs(r, 3, 8, 12))
    *dims, r_pad = seen[0][-5:]
    assert dims == [r, 3, 8, 12] and r_pad % 4 == 0 and r <= r_pad < r + 4
    assert made[0] == (2, 8, 3, r_pad)


def test_counted_kernels_end_with_kernel_8_and_the_table_declares_it():
    # kernel 8 between kernel 7 and kernel 9 (tests/test_torch_whh_grad_f32.py)
    assert len(COUNTED_KERNELS) == 10 and COUNTED_KERNELS[8] is proj_kernel.input_proj_f32_wgrad
    assert COUNTED_KERNELS[7] is proj_kernel.input_proj_f32
    assert sorted(_build.ENTRIES["wgrad_f32.cu"]) == ["wgrad_f32_launch", "wgrad_f32_smem_bytes"]
    assert sum(len(entries) for entries in _build.ENTRIES.values()) == 21


@pytest.fixture
def routed(stand_in, monkeypatch):
    """Every call of the op on CPU tensors runs the CUDA body under the
    stand-in and returns the plain version's gradients, and so does kernel
    7's op with its gates; returns the shapes of the x and dgates kernel 8
    was called with."""
    seen = []

    def op(x, dxf, dxb):
        seen.append((tuple(x.shape), tuple(dxf.shape), tuple(dxb.shape)))
        proj_kernel._wgrad_cuda(x, dxf, dxb)
        return proj_kernel.input_proj_f32_wgrad_reference(x, dxf, dxb)

    def forward_op(*args):
        proj_kernel._f32_cuda(*args)
        return proj_kernel.input_proj_f32_reference(*args)

    monkeypatch.setattr(proj_kernel, "_wgrad_op", op)
    monkeypatch.setattr(proj_kernel, "_f32_op", forward_op)
    return seen


@pytest.mark.parametrize("use_kernels, compute_dtype, calls", [
    (True, "float32", 1), (False, "float32", 0), (True, "bfloat16", 0)])
def test_the_train_step_routes_the_appearance_weight_gradient(routed, monkeypatch, use_kernels, compute_dtype,
                                                              calls):
    """One call a train step, from the appearance op's backward (x of width
    vision_dim, R = batch * clips rows, the dgates (T, R, 4H)), beside one
    call of kernel 7 in its forward, so ``proj.tc_f32_wgrad_rows`` equals
    ``proj.tc_f32_rows``; none on the plain path or under bf16 streaming.
    The step's loss and gradients are those of the products before, bit
    for bit."""
    batch = _batch()
    model = _model(use_kernels=use_kernels, compute_dtype=compute_dtype)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 10), seed=3)
    n0 = proj_kernel.input_proj_f32_wgrad.launches
    trace.enable()
    train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)
    trace.disable()
    b, c, f, d = batch[0].shape
    g = 4 * (TINY["module_dim"] // 2)
    assert routed == [((b * c, f, d), (f, b * c, g), (f, b * c, g))] * calls
    assert proj_kernel.input_proj_f32_wgrad.launches == n0 + calls
    counters = trace.counters()
    assert counters.get("proj.tc_f32_wgrad_rows", 0) == calls * b * c * f == counters.get("proj.tc_f32_rows", 0)
    if calls:
        runs = []
        for old in (False, True):
            if old:
                monkeypatch.setattr(lstm_train, "input_proj_f32_wgrad",
                                    lambda x, dxf, dxb: _products_before(x, dxf, dxb))
            state.model.zero_grad()
            state.generator.manual_seed(11)
            loss = train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)["loss"]
            runs.append((loss, [p.grad.clone() for p in state.model.parameters()]))
        (loss_k8, grads_k8), (loss_old, grads_old) = runs
        assert torch.isfinite(loss_k8) and torch.equal(loss_k8, loss_old)
        assert all(torch.equal(a, b) for a, b in zip(grads_k8, grads_old))
        assert len(routed) == 2 * calls


@pytest.mark.parametrize("name", list(proj_kernel_ab.K8_VARIANTS))
def test_the_ab_tools_kernel_8_variants_apply_to_the_source(name):
    """Each build variant of ``bench/proj_kernel_ab.py --kernel 8`` finds the
    lines it changes in ``csrc/wgrad_f32.cu`` (the tool runs only on the
    card, so a renamed line would show only there)."""
    text = (_build.CSRC / proj_kernel_ab.K8_SOURCE).read_text()
    changes, _ = proj_kernel_ab.K8_VARIANTS[name]
    variant = proj_kernel_ab.apply_changes(text, changes, proj_kernel_ab.K8_SOURCE)
    assert (variant == text) == (not changes)
