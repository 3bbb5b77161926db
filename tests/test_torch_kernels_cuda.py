"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode; on a CPU tensor the wrappers run the plain version, which the
CPU tests hold against the JAX package). The file imports neither JAX nor
the JAX package, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 throughout, TF32 off. Tolerances: recurrence 1e-4 absolute; graph
cycle, model outputs and the training backward's gradients
1e-3 * max(1, max|ref|) (fp32 sums in another order; the backward carries
gradients over T steps and a product over 4H).
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.ops import gat_kernel, lstm_kernel, lstm_train, lstm_train_kernel

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
