"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode; on a CPU tensor the wrappers run the plain version, which the
CPU tests hold against the JAX package). The file imports neither JAX nor
the JAX package, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 arithmetic, TF32 off. The tanh pass is compared bit for bit.
Tolerances: recurrence 1e-4 absolute; graph
cycle, model outputs and the training backward's gradients
1e-3 * max(1, max|ref|) (fp32 sums in another order; the backward carries
gradients over T steps and a product over 4H). Outputs in bf16 (kernels 5
and 6, kernel 1 with bf16 gates) may differ from the plain version by one
bf16 rounding step of the reference's magnitude, where a sum taken in
another order crosses a rounding boundary, plus the fp32 tolerance for
values near zero.
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.bench.proj_probe import compare
from dualvgr_tpu_torch.ops import gat_kernel, lstm_kernel, lstm_train, lstm_train_kernel, precision, proj_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rs():
    return np.random.RandomState(0)


def _t(rs, dev, *shape, scale=1.0):
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("r,t,h,masked,with_outputs", [
    (37, 5, 16, True, True),     # ragged row tile, small hidden
    (40, 9, 384, False, False),  # the flagship hidden width
    (19, 12, 100, True, False),  # hidden not a multiple of the unit lanes
    (256, 24, 384, True, True),  # the question encoders' shape
])
def test_recurrence_kernel_matches_plain(rs, cuda, r, t, h, masked, with_outputs):
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g), _t(rs, cuda, t, r, g)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda) if masked else None
    before = lstm_kernel.bilstm_recurrence.launches
    got = lstm_kernel.bilstm_recurrence(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    torch.cuda.synchronize()
    assert lstm_kernel.bilstm_recurrence.launches == before + 1
    want = lstm_kernel.bilstm_recurrence_reference(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    got, want = (got, want) if with_outputs else ((got,), (want,))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-4


def test_recurrence_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(3, 4, 32, device=cuda)
    w = torch.zeros(8, 32, device=cuda)
    with pytest.raises(TypeError):
        lstm_kernel.bilstm_recurrence(x.double(), x.double(), w.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_kernel.bilstm_recurrence(x.transpose(0, 1).contiguous().transpose(0, 1), x, w, w)
    with pytest.raises(ValueError, match="hidden"):
        big = torch.zeros(2, 2, 4 * 388, device=cuda)
        lstm_kernel.bilstm_recurrence(big, big, torch.zeros(388, 4 * 388, device=cuda),
                                      torch.zeros(388, 4 * 388, device=cuda))


@pytest.mark.parametrize("b,n,d,heads,broadcast", [
    (5, 4, 64, 4, True),      # tile height 8, per-clip scores as a stride-0 view
    (9, 16, 768, 4, False),   # flagship width
    (3, 20, 200, 4, True),    # the largest tile, D not a multiple of the lanes
])
def test_gat_cycle_kernel_matches_plain(rs, cuda, b, n, d, heads, broadcast):
    hd = d // heads
    h = _t(rs, cuda, b, n, d)
    if broadcast:
        scores = torch.from_numpy(rs.rand(b, n, 1).astype(np.float32)).to(cuda).expand(b, n, hd)
    else:
        scores = torch.from_numpy(rs.rand(b, n, hd).astype(np.float32)).to(cuda)
    w = lambda *s: _t(rs, cuda, *s, scale=1.0 / np.sqrt(s[0]))
    args = (w(d, d), w(d), w(heads, 2 * hd), w(heads), w(d, d), w(d), w(heads, 2 * hd), w(heads),
            w(d, d), w(d), w(d, 1))
    before = gat_kernel.gat_cycle.launches
    got = gat_kernel.gat_cycle(h, scores, *args)
    torch.cuda.synchronize()
    assert gat_kernel.gat_cycle.launches == before + 1
    want = gat_kernel.gat_cycle_reference(h, scores, *args)
    for a, r in zip(got, want):
        assert (a - r).abs().max().item() <= 1e-3 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 1), (1, 2)])
def test_model_kernel_path_matches_plain_path(rs, cuda, unit_layers, graph_layers):
    model = build_model(device=cuda, vision_dim=64, module_dim=64, word_dim=16,
                        question_vocab_size=40, num_answers=30, num_of_nodes=6,
                        graph_layers=graph_layers, unit_layers=unit_layers)
    b, t = 5, 9
    app, mot = _t(rs, cuda, b, 6, 4, 64), _t(rs, cuda, b, 6, 64)
    qlen = torch.from_numpy(rs.randint(1, t + 1, (b,)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rs.randint(1, 40, (b, t)).astype(np.int32)).to(cuda)
    n0 = (lstm_kernel.bilstm_recurrence.launches, gat_kernel.gat_cycle.launches)
    got = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    fused = 2 * unit_layers if graph_layers == 1 else 0
    assert (lstm_kernel.bilstm_recurrence.launches - n0[0], gat_kernel.gat_cycle.launches - n0[1]) == (3, fused)
    model.use_kernels = False
    want = model(app, mot, q, qlen)
    for field in got._fields:
        a, r = getattr(got, field), getattr(want, field)
        assert (a - r).abs().max().item() <= 1e-3 * max(1.0, r.abs().max().item()), field


def _close(a, b, tol, name):
    assert a.shape == b.shape, name
    err = (a - b).abs().max().item()
    assert err <= tol * max(1.0, b.abs().max().item()), f"{name}: max abs err {err:.3e}"


@pytest.mark.parametrize("r,t,h,masked,with_outputs", [
    (37, 5, 16, True, True),      # ragged row tile, small hidden
    (40, 9, 384, False, False),   # the flagship hidden width, final only
    (19, 12, 100, True, False),   # hidden not a multiple of the unit lanes
    (256, 24, 384, True, True),   # the question encoders' shape
    (1100, 6, 384, True, True),   # enough rows for the 16-row tile, ragged
])
def test_train_kernels_match_plain(rs, cuda, r, t, h, masked, with_outputs):
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g), _t(rs, cuda, t, r, g)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda) if masked else None
    n0 = (lstm_train_kernel.bilstm_train_fwd.launches, lstm_train_kernel.bilstm_train_bwd.launches)
    got = lstm_train_kernel.bilstm_train_fwd(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    torch.cuda.synchronize()
    want = lstm_train_kernel.bilstm_train_fwd_reference(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    for a, b, name in zip(got, want, ("final", "outs", "hprev", "cprev")):
        if b is None:
            assert a is None
            continue
        _close(a, b, 1e-4, name)
    _, _, hprev, cprev = want
    dfinal = _t(rs, cuda, r, 2 * h)
    douts = _t(rs, cuda, r, t, 2 * h) if with_outputs else None
    got = lstm_train_kernel.bilstm_train_bwd(xf, xb, wf, wb, lens, hprev, cprev, dfinal, douts)
    torch.cuda.synchronize()
    assert (lstm_train_kernel.bilstm_train_fwd.launches, lstm_train_kernel.bilstm_train_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = lstm_train_kernel.bilstm_train_bwd_reference(xf, xb, wf, wb, lens, hprev, cprev, dfinal, douts)
    for a, b, name in zip(got, want, ("dxf", "dxb")):
        _close(a, b, 1e-3, name)


@pytest.mark.parametrize("masked,with_outputs", [(False, False), (True, True), (True, False)])
def test_trainable_function_matches_autograd_of_plain(rs, cuda, masked, with_outputs):
    r, t, h = 70, 7, 64
    g = 4 * h
    data = [_t(rs, cuda, t, r, g), _t(rs, cuda, t, r, g), _t(rs, cuda, h, g, scale=0.1),
            _t(rs, cuda, h, g, scale=0.1)]
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda) if masked else None
    tgt_f, tgt_o = _t(rs, cuda, r, 2 * h), _t(rs, cuda, r, t, 2 * h)

    def run(fn):
        leaves = [d.clone().requires_grad_() for d in data]
        final, outs = fn(*leaves)
        loss = ((final - tgt_f) ** 2).sum()
        if with_outputs:
            loss = loss + ((outs - tgt_o) ** 2).sum()
        loss.backward()
        return [final, outs] + [p.grad for p in leaves]

    def plain(*a):
        res = lstm_kernel.bilstm_recurrence_reference(*a, lens, with_outputs=with_outputs)
        return res if with_outputs else (res, None)

    got = run(lambda *a: lstm_train.bilstm_trainable(*a, lens, with_outputs=with_outputs))
    want = run(plain)
    for a, b, name in zip(got, want, ("final", "outs", "dxf", "dxb", "dwf", "dwb")):
        if b is None:
            assert a is None
            continue
        _close(a.detach(), b.detach(), 1e-3, name)


def test_kernel_wrappers_refuse_inputs_that_require_grad_on_the_card(cuda):
    x = torch.zeros(3, 4, 32, device=cuda)
    w = torch.zeros(8, 32, device=cuda, requires_grad=True)
    for fn in (lstm_kernel.bilstm_recurrence, lstm_train_kernel.bilstm_train_fwd):
        before = fn.launches
        with pytest.raises(RuntimeError, match="autograd"):
            fn(x, x, w, w)
        assert fn.launches == before
        with torch.no_grad():
            fn(x, x, w, w)
        assert fn.launches == before + 1


@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (1, 2)])
def test_train_step_kernel_path_matches_plain_path(rs, cuda, unit_layers, graph_layers):
    """One train step's loss and per-module gradient norms, kernel path
    against plain path: loss within 1e-4 relative, norms within 1e-3
    relative; the kernel path launches kernels 3 and 4 once per BiLSTM and
    neither eval kernel.

    Compared after two updates, with dropout on and the same masks on both
    paths (the generator reseeded; the kernels draw nothing). At the zero
    biases of the init QueryAttn normalizes exactly-zero vectors, and with
    dropout off stacked GATs can emit nodes equal to rounding, whose common
    loss then normalizes noise: there rounding differences move the
    gradient norms past the tolerance in any implementation.
    """
    from dualvgr_tpu_torch import train_lib

    model = build_model(device=cuda, vision_dim=64, module_dim=64, word_dim=16,
                        question_vocab_size=40, num_answers=30, num_of_nodes=6,
                        graph_layers=graph_layers, unit_layers=unit_layers)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-4, 10))
    b, t = 7, 9
    qlen = torch.from_numpy(rs.randint(1, t + 1, (b,)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rs.randint(1, 40, (b, t)).astype(np.int32)).to(cuda)
    valid = torch.ones(b, device=cuda)
    valid[-2:] = 0.0
    batch = (_t(rs, cuda, b, 6, 4, 64), _t(rs, cuda, b, 6, 64), q, qlen,
             torch.from_numpy(rs.randint(0, 30, (b,))).to(cuda), valid)
    for _ in range(2):
        train_lib.train_step(state, batch, alpha=1.0, beta=1e-8)
    kernels = (lstm_kernel.bilstm_recurrence, gat_kernel.gat_cycle,
               lstm_train_kernel.bilstm_train_fwd, lstm_train_kernel.bilstm_train_bwd)
    n0 = [k.launches for k in kernels]

    def step():
        state.generator.manual_seed(11)
        loss = train_lib.forward_backward(state, batch, alpha=1.0, beta=1e-8)["loss"].item()
        norms = {name: torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in mod.parameters()])).item()
                 for name, mod in model.named_children()}
        return loss, norms

    loss_k, norms_k = step()
    assert [k.launches - n for k, n in zip(kernels, n0)] == [0, 0, 3, 3]
    model.use_kernels = False
    loss_p, norms_p = step()
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    for name, v in norms_p.items():
        assert abs(norms_k[name] - v) <= 1e-3 * v, name


def _close_bf16(a, b, atol, name, max_share=1.0):
    """bf16 outputs: within one bf16 step of the reference plus ``atol``, on
    at most ``max_share`` of the elements."""
    assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape, name
    steps, share, ok = compare(a, b, atol)
    assert ok, f"{name}: {steps:.2f} bf16 steps beyond {atol}"
    assert share <= max_share, f"{name}: {share:.2e} of the elements differ"


@pytest.mark.parametrize("r,t,d,g", [
    (37, 5, 40, 64),        # ragged row tile (M = 185), K = 40 < one 64-deep k-block
    (37, 5, 72, 200),       # K not a multiple of 64; 4H = 200: an N tile straddles the directions
    (1, 7, 72, 64),         # R = 1
    (1, 16, 2048, 1536),    # R = 1 at the flagship widths
    (512, 16, 2048, 1536),  # the serving batch of 32
    (4096, 16, 2048, 1536), # the flagship batch of 256
])
def test_input_proj_kernels_match_plain(rs, cuda, r, t, d, g):
    x = _t(rs, cuda, r, t, d)
    w_f, w_b = _t(rs, cuda, g, d, scale=0.02), _t(rs, cuda, g, d, scale=0.02)
    b_f, b_b = _t(rs, cuda, g), _t(rs, cuda, g)
    n0 = (proj_kernel.input_proj_one.launches, proj_kernel.input_proj_both.launches)
    n_tanh = proj_kernel.tanh_to_bf16.launches
    # about 1e-3 of the sums cross a rounding boundary in another order: at
    # most 2e-3 of the elements, or 4 of a small output, may differ
    share = max(2e-3, 4 / (t * r * g))
    for reverse in (False, True):
        got = proj_kernel.input_proj_one(x, w_f, b_f, reverse=reverse)
        torch.cuda.synchronize()
        _close_bf16(got, proj_kernel.input_proj_one_reference(x, w_f, b_f, reverse=reverse), 1e-5,
                    f"kernel 5 reverse={reverse}", share)
    x16 = torch.tanh(x).to(torch.bfloat16)
    for fuse, xin in ((True, x), (False, x16)):
        got = proj_kernel.input_proj_both(xin, w_f, b_f, w_b, b_b, fuse_tanh=fuse)
        torch.cuda.synchronize()
        want = proj_kernel.input_proj_both_reference(xin, w_f, b_f, w_b, b_b, fuse_tanh=fuse)
        for a, b, name in zip(got, want, ("xf", "xb_rev")):
            _close_bf16(a, b, 1e-5, f"kernel 6 fuse_tanh={fuse} {name}", share)
    assert (proj_kernel.input_proj_one.launches, proj_kernel.input_proj_both.launches) == (n0[0] + 2, n0[1] + 2)
    # one tanh pass for each call on fp32 x: both of kernel 5's and the fused kernel 6's
    assert proj_kernel.tanh_to_bf16.launches == n_tanh + 3


@pytest.mark.parametrize("shape", [(37, 5, 40), (512, 16, 2048)])
def test_tanh_pass_is_bit_exact(rs, cuda, shape):
    """The tanh pass equals ``torch.tanh(x).to(bfloat16)`` bit for bit: the
    same accurate tanhf, rounded to nearest even."""
    x = _t(rs, cuda, *shape, scale=2.0)
    before = proj_kernel.tanh_to_bf16.launches
    got = proj_kernel.tanh_to_bf16(x)
    torch.cuda.synchronize()
    assert proj_kernel.tanh_to_bf16.launches == before + 1
    want = proj_kernel.tanh_to_bf16_reference(x)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_input_proj_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    w, b = torch.zeros(64, 40, device=cuda), torch.zeros(64, device=cuda)
    n0 = (proj_kernel.input_proj_one.launches, proj_kernel.input_proj_both.launches,
          proj_kernel.tanh_to_bf16.launches)
    with pytest.raises(TypeError):
        proj_kernel.input_proj_both(torch.zeros(3, 4, 40, device=cuda), w, b, w, b, fuse_tanh=False)
    with pytest.raises(ValueError, match="% 8"):
        proj_kernel.input_proj_one(torch.zeros(3, 4, 36, device=cuda), torch.zeros(64, 36, device=cuda), b)
    # x neither contiguous nor 16-byte aligned: TMA and the 16-byte vectors refuse it
    with pytest.raises(ValueError, match="contiguous"):
        proj_kernel.input_proj_one(torch.zeros(4, 3, 40, device=cuda).transpose(0, 1), w, b)
    for dtype, fuse in ((torch.float32, True), (torch.bfloat16, False)):
        offset = torch.zeros(3 * 4 * 40 + 1, device=cuda, dtype=dtype)[1:].view(3, 4, 40)
        with pytest.raises(ValueError, match="aligned"):
            proj_kernel.input_proj_both(offset, w, b, w, b, fuse_tanh=fuse)
    with pytest.raises(ValueError, match="aligned"):
        proj_kernel.tanh_to_bf16(torch.zeros(3 * 4 * 40 + 1, device=cuda)[1:].view(3, 4, 40))
    assert (proj_kernel.input_proj_one.launches, proj_kernel.input_proj_both.launches,
            proj_kernel.tanh_to_bf16.launches) == n0


def test_mm_f32_keeps_an_fp32_output(rs, cuda):
    """The streamed product on the card: bf16 operands, fp32 sums and an
    fp32 output, equal to the fp32 product of the rounded operands up to the
    order of the sums."""
    a = _t(rs, cuda, 300, 512).to(torch.bfloat16)
    b = _t(rs, cuda, 512, 200).to(torch.bfloat16)
    got = precision.mm_f32(a, b)
    assert got.dtype == torch.float32
    want = a.float() @ b.float()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("r,t,h,masked,with_outputs", [
    (37, 5, 16, True, True),
    (4096, 16, 384, False, False),  # the appearance encoder
    (256, 24, 384, True, True),     # the question encoders
])
def test_recurrence_kernel_with_bf16_gates_matches_plain(rs, cuda, r, t, h, masked, with_outputs):
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g).to(torch.bfloat16), _t(rs, cuda, t, r, g).to(torch.bfloat16)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda) if masked else None
    got = lstm_kernel.bilstm_recurrence(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    torch.cuda.synchronize()
    want = lstm_kernel.bilstm_recurrence_reference(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    got, want = (got, want) if with_outputs else ((got,), (want,))
    for a, b, name in zip(got, want, ("final", "outs")):
        _close_bf16(a, b, 1e-4, name)


@pytest.mark.parametrize("r,t,h", [(37, 5, 16), (4096, 16, 384)])
def test_train_kernels_with_bf16_gates_match_plain(rs, cuda, r, t, h):
    """The appearance op's shape: full length, final only, bf16 gates; the
    outputs and the dgates stay fp32."""
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g).to(torch.bfloat16), _t(rs, cuda, t, r, g).to(torch.bfloat16)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    got = lstm_train_kernel.bilstm_train_fwd(xf, xb, wf, wb)
    torch.cuda.synchronize()
    want = lstm_train_kernel.bilstm_train_fwd_reference(xf, xb, wf, wb)
    for a, b, name in zip(got, want, ("final", "outs", "hprev", "cprev")):
        if b is None:
            continue
        assert a.dtype == torch.float32, name
        _close(a, b, 1e-4, name)
    _, _, hprev, cprev = want
    dfinal = _t(rs, cuda, r, 2 * h)
    got = lstm_train_kernel.bilstm_train_bwd(xf, xb, wf, wb, None, hprev, cprev, dfinal)
    torch.cuda.synchronize()
    want = lstm_train_kernel.bilstm_train_bwd_reference(xf, xb, wf, wb, None, hprev, cprev, dfinal)
    for a, b, name in zip(got, want, ("dxf", "dxb")):
        assert a.dtype == torch.float32, name
        _close(a, b, 1e-3, name)


@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (1, 2)])
def test_bf16_model_kernel_path_launches_and_stays_near_fp32(rs, cuda, unit_layers, graph_layers):
    """The bf16 eval forward on the card: kernel 6 once, kernel 1 three times
    with bf16 gates, kernel 2 once per stream and unit with graph_layers 1;
    logits within 5e-2 * max|logit| of the fp32 kernel path (bf16 operands
    and gates against fp32)."""
    model = build_model(device=cuda, compute_dtype="bfloat16", vision_dim=64, module_dim=64, word_dim=16,
                        question_vocab_size=40, num_answers=30, num_of_nodes=6,
                        graph_layers=graph_layers, unit_layers=unit_layers)
    b, t = 5, 9
    app, mot = _t(rs, cuda, b, 6, 4, 64), _t(rs, cuda, b, 6, 64)
    qlen = torch.from_numpy(rs.randint(1, t + 1, (b,)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rs.randint(1, 40, (b, t)).astype(np.int32)).to(cuda)
    kernels = (proj_kernel.input_proj_both, lstm_kernel.bilstm_recurrence, gat_kernel.gat_cycle)
    n0 = [k.launches for k in kernels]
    got = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    fused = 2 * unit_layers if graph_layers == 1 else 0
    assert [k.launches - n for k, n in zip(kernels, n0)] == [1, 3, fused]
    model.compute_dtype = "float32"
    want = model(app, mot, q, qlen)
    scale = want.logits.abs().max().item()
    assert (got.logits - want.logits).abs().max().item() <= 5e-2 * scale
