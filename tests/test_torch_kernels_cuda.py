"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode; on a CPU tensor the wrappers run the plain version, which the
CPU tests hold against the JAX package). The file imports neither JAX nor
the JAX package, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 arithmetic, TF32 off. The tanh pass is compared bit for bit. Kernel 7
(3xTF32) is held against the fp64 product: at the train cells' shapes its
relative Frobenius error is at most twice ``torch.baddbmm``'s in fp32,
and ``baddbmm`` in TF32 falls outside that bound (so the rule tells plain
TF32 apart); at small ragged shapes within that bound or 1e-6. Kernel 8
(3xTF32, dW_ih over K = R*T) likewise against the library SGEMMs' fp32
error. Kernel 9 (3xTF32, dW_hh over K = R*T split across the SMs) within
the library SGEMMs' fp32 error itself, on kernels 3 and 4's own hprev and
dgates at the question shapes with ragged lengths too, and the same bits
on every run of one input.
Tolerances: recurrence 1e-4 absolute; graph
cycle, model outputs and the training backward's gradients
1e-3 * max(1, max|ref|) (fp32 sums in another order; the backward carries
gradients over T steps and a product over 4H). Outputs in bf16 (kernels 5
and 6, kernel 1 with bf16 gates) may differ from the plain version by one
bf16 rounding step of the reference's magnitude, where a sum taken in
another order crosses a rounding boundary, plus the fp32 tolerance for
values near zero. The last tests hold ``prefetch_to_device`` (pinned
batches copied on a side stream) to the loader's host batches, exactly,
its span and counters to the items it copies, and two gloo ranks sharing the card (``parallel/dryrun.py``) to one
process's train step.
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.bench.proj_kernel_ab import (
    baddbmm_errors, f32_inputs, fp64_product, fp64_wgrad, fp64_whh, rel_error, sgemm_errors, wgrad_inputs,
    whh_inputs, whh_sgemm_errors,
)
from dualvgr_tpu_torch.bench.proj_probe import compare
from dualvgr_tpu_torch.ops import (
    _build, gat_kernel, lstm_kernel, lstm_train, lstm_train_kernel, precision, proj_kernel, whh_grad_kernel,
)
from dualvgr_tpu_torch.utils import trace

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
    (4096, 16, 384, False, False),  # the appearance encoder: more items than clusters
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


def test_cluster_kernels_are_deterministic(rs, cuda):
    """Two launches on the same inputs give the same bits: the cluster
    kernels sum in a fixed order and use no atomics."""
    r, t, h = 1100, 7, 384
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g), _t(rs, cuda, t, r, g)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda)
    for fn in (lstm_kernel.bilstm_recurrence, lstm_train_kernel.bilstm_train_fwd):
        runs = [fn(xf, xb, wf, wb, lens, with_outputs=True) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            if a is not None:
                assert torch.equal(a, b)
    # kernel 4 on kernel 3's activations and c_{t-1}
    *_, cprev, acts = runs[0]
    dfinal, douts = _t(rs, cuda, r, 2 * h), _t(rs, cuda, r, t, 2 * h)
    runs = [lstm_train_kernel.bilstm_train_bwd(acts, wf, wb, lens, cprev, dfinal, douts) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_cluster_entry_refuses_a_plan_it_cannot_run(rs, cuda):
    """The C entry checks the plan's numbers against its build and returns
    cudaErrorInvalidValue (1) for any it cannot run; nothing launches."""
    r, t, h = 40, 3, 384
    xf = _t(rs, cuda, t, r, 4 * h)
    w = _t(rs, cuda, h, 4 * h, scale=0.1)
    final = torch.empty(r, 2 * h, device=cuda)
    fn = _build.entry("bilstm_recurrence_launch")
    plan = lstm_kernel.launch_plan("bilstm_recurrence", r, h, 0)
    good = lstm_kernel.plan_args(plan)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (xf.data_ptr(), xf.data_ptr(), w.data_ptr(), w.data_ptr(), None, final.data_ptr(), None)
    for bad in ((8,) + good[1:], (16, 20) + good[2:], good[:2] + (8, good[3]), good[:3] + (0,),
                good[:3] + (2 * plan.tiles + 1,)):
        assert fn(*ptrs, t, r, h, 0, *bad, stream) == 1, bad
    assert fn(*ptrs, t, r, h, 0, *good, stream) == 0
    torch.cuda.synchronize()
    # kernel 4's entry checks its own plan the same way (it takes no gate type)
    acts = torch.sigmoid(_t(rs, cuda, 2, t, r, 4 * h))
    res = _t(rs, cuda, t, r, 2 * h)
    dx = torch.empty(t, r, 4 * h, device=cuda)
    fn = _build.entry("bilstm_train_bwd_launch")
    plan = lstm_kernel.launch_plan("bilstm_train_bwd", r, h, None, plan=lstm_kernel.backward_plan)
    good = lstm_kernel.plan_args(plan)
    ptrs = (acts.data_ptr(), w.data_ptr(), w.data_ptr(), None, res.data_ptr(), final.data_ptr(), None,
            dx.data_ptr(), dx.data_ptr())
    for bad in ((8,) + good[1:], (16, 20) + good[2:], good[:2] + (8, good[3]), good[:3] + (0,),
                good[:3] + (2 * plan.tiles + 1,)):
        assert fn(*ptrs, t, r, h, *bad, stream) == 1, bad
    assert fn(*ptrs, t, r, h, *good, stream) == 0
    torch.cuda.synchronize()


def test_cluster_plan_shared_memory_is_the_builds(cuda):
    """The plan's shared memory per CTA (``lstm_kernel.smem_bytes``) is what
    each cluster library launches with, at every H it takes."""
    for prefix, plan in (("bilstm_recurrence", lstm_kernel.recurrence_plan),
                         ("bilstm_train_fwd", lstm_kernel.recurrence_plan),
                         ("bilstm_train_bwd", lstm_kernel.backward_plan)):
        for h in range(4, lstm_kernel.MAX_HIDDEN + 1, 4):
            want = plan(16, h, 1).smem_bytes
            assert lstm_kernel.library_smem_bytes(prefix, h) == want, (prefix, h)


def _gat_inputs(rs, dev, b, n, d, heads, broadcast):
    """h, scores (a stride-0 view of one score per clip, or a full
    (B, N, hd) tensor) and the cycle's eleven weights, seeded."""
    hd = d // heads
    h = _t(rs, dev, b, n, d)
    if broadcast:
        scores = torch.from_numpy(rs.rand(b, n, 1).astype(np.float32)).to(dev).expand(b, n, hd)
    else:
        scores = torch.from_numpy(rs.rand(b, n, hd).astype(np.float32)).to(dev)
    w = lambda *s: _t(rs, dev, *s, scale=1.0 / np.sqrt(s[0]))
    args = (w(d, d), w(d), w(heads, 2 * hd), w(heads), w(d, d), w(d), w(heads, 2 * hd), w(heads),
            w(d, d), w(d), w(d, 1))
    return h, scores, args


@pytest.mark.parametrize("b,n,d,heads,broadcast", [
    (5, 4, 64, 4, True),      # tile height 8, per-clip scores as a stride-0 view
    (9, 16, 768, 4, False),   # flagship width
    (3, 20, 200, 4, True),    # the largest tile, D not a multiple of the lanes
    (1, 16, 768, 4, True),    # one video: one cluster
    (32, 16, 768, 4, True),   # the serving batch
    (40, 8, 768, 4, True),    # the smallest shipped clip count
    (256, 8, 768, 4, True),   # the flagship batch at N = 8: a tile height that is not a multiple of 4
    (30, 20, 768, 4, False),  # the largest shipped clip count
    (255, 16, 768, 4, True),  # a batch that is not a multiple of the plan's videos per cluster
    (255, 16, 768, 4, False),
])
def test_gat_cycle_kernel_matches_plain(rs, cuda, b, n, d, heads, broadcast):
    h, scores, args = _gat_inputs(rs, cuda, b, n, d, heads, broadcast)
    if b == 255:
        plan = gat_kernel.card_plan(b, n, d, heads)
        assert len({len(gat_kernel.cluster_videos(plan, b, c)) for c in range(plan.clusters)}) == 2
    before = gat_kernel.gat_cycle.launches
    got = gat_kernel.gat_cycle(h, scores, *args)
    torch.cuda.synchronize()
    assert gat_kernel.gat_cycle.launches == before + 1
    want = gat_kernel.gat_cycle_reference(h, scores, *args)
    for a, r in zip(got, want):
        assert (a - r).abs().max().item() <= 1e-3 * max(1.0, r.abs().max().item())


def test_gat_cycle_kernel_is_deterministic(rs, cuda):
    """No atomics: the cluster's partial scores are summed in CTA order, so
    two launches on the same inputs give the same bits."""
    h, scores, args = _gat_inputs(rs, cuda, 37, 16, 768, 4, True)
    first = gat_kernel.gat_cycle(h, scores, *args)
    second = gat_kernel.gat_cycle(h, scores, *args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_gat_cycle_plan_shared_memory_is_the_builds(cuda):
    """The plan's shared memory per CTA (``gat_kernel.smem_bytes``) is what
    the library launches with, at the shipped and the tested dims and
    batches; the library refuses a plan it cannot run."""
    for n, d, heads in ((8, 768, 4), (16, 768, 4), (20, 768, 4), (4, 64, 4), (20, 200, 4), (20, 768, 1),
                        (20, 764, 4), (20, 768, 3)):
        for b in (1, 5, 32, 256):
            for plan in (gat_kernel.cycle_plan(b, n, d, heads), gat_kernel.card_plan(b, n, d, heads)):
                assert gat_kernel.library_smem_bytes(b, n, d, heads, plan) == plan.smem_bytes, (n, d, heads, b)
                assert gat_kernel.active_clusters(b, n, d, heads, plan) >= 1
    fn = _build.entry("gat_cycle_smem_bytes")
    for bad in ((256, 16, 768, 4, 4, 64, 17, 8), (256, 16, 768, 4, 3, 64, 16, 8), (256, 16, 768, 4, 4, 16, 16, 8),
                (32, 21, 768, 4, 4, 32, 16, 8), (32, 16, 772, 4, 4, 32, 16, 8), (32, 16, 768, 4, 16, 32, 16, 8),
                (32, 16, 768, 4, 4, 33, 16, 8), (32, 16, 768, 4, 4, 32, 16, 3), (32, 16, 768, 4, 4, 32, 16, 9)):
        assert fn(*bad) == -1, bad


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


@pytest.mark.parametrize("nodes,graph_layers", [(32, 1), (6, 2)])
def test_gcn_model_builds_and_launches_kernel_1_only(rs, cuda, nodes, graph_layers):
    """A GCN model builds on the card with 32 nodes (the graph-cycle limits
    bind the GAT module only); its forward launches kernel 1 three times and
    kernel 2 never, and matches its plain path."""
    model = build_model(device=cuda, vision_dim=64, module_dim=64, word_dim=16, question_vocab_size=40,
                        num_answers=30, num_of_nodes=nodes, graph_layers=graph_layers, unit_layers=2,
                        graph_module="GCN")
    b, t = 5, 9
    app, mot = _t(rs, cuda, b, nodes, 4, 64), _t(rs, cuda, b, nodes, 64)
    qlen = torch.from_numpy(rs.randint(1, t + 1, (b,)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rs.randint(1, 40, (b, t)).astype(np.int32)).to(cuda)
    n0 = (lstm_kernel.bilstm_recurrence.launches, gat_kernel.gat_cycle.launches)
    got = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    assert (lstm_kernel.bilstm_recurrence.launches - n0[0], gat_kernel.gat_cycle.launches - n0[1]) == (3, 0)
    model.use_kernels = False
    want = model(app, mot, q, qlen)
    for field in got._fields:
        a, r = getattr(got, field), getattr(want, field)
        assert a.device.type == "cuda" and torch.isfinite(a).all(), field
        assert (a - r).abs().max().item() <= 1e-3 * max(1.0, r.abs().max().item()), field


def test_zoo_runs_on_cuda_tensors(cuda):
    """Every class of the zoos on CUDA tensors matches the same module on the
    CPU, and no torch function returns a CPU tensor on the way
    (``bench/zoo_check.py``)."""
    from dualvgr_tpu_torch.bench.zoo_check import CASES, TOL, check_zoo

    errs = check_zoo(cuda)
    assert sorted(errs) == sorted(CASES) and max(errs.values()) <= TOL


def _close(a, b, tol, name):
    assert a.shape == b.shape, name
    err = (a - b).abs().max().item()
    assert err <= tol * max(1.0, b.abs().max().item()), f"{name}: max abs err {err:.3e}"


@pytest.mark.parametrize("r,t,h,masked,with_outputs", [
    (37, 5, 16, True, True),      # ragged row tile, small hidden
    (40, 9, 384, False, False),   # the flagship hidden width, final only
    (19, 12, 100, True, False),   # hidden not a multiple of the unit lanes
    (256, 24, 384, True, True),   # the question encoders' shape
    (1100, 6, 384, True, True),   # more items than clusters, ragged
    (1100, 5, 100, True, False),  # the ragged item walk with a CTA that owns no unit
    (1, 8, 384, True, True),      # one row
    (4096, 16, 384, False, False),  # the appearance encoder
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
    for a, b, name in zip(got, want, ("final", "outs", "hprev", "cprev", "acts")):
        if b is None:
            assert a is None
            continue
        _close(a, b, 1e-4, name)
    dfinal = _t(rs, cuda, r, 2 * h)
    douts = _t(rs, cuda, r, t, 2 * h) if with_outputs else None
    # kernel 4 on kernel 3's activations and c_{t-1}; the plain backward on the plain forward's
    got = lstm_train_kernel.bilstm_train_bwd(got[4], wf, wb, lens, got[3], dfinal, douts)
    torch.cuda.synchronize()
    assert (lstm_train_kernel.bilstm_train_fwd.launches, lstm_train_kernel.bilstm_train_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    want = lstm_train_kernel.bilstm_train_bwd_reference(want[4], wf, wb, lens, want[3], dfinal, douts)
    for a, b, name in zip(got, want, ("dxf", "dxb")):
        _close(a, b, 1e-3, name)


@pytest.mark.parametrize("on", [True, False])
def test_train_forward_counts_the_activation_bytes_it_keeps(rs, cuda, on):
    """Each launch of kernel 3 counts the bytes of its ``acts``, (2, T, R,
    4H) fp32, in ``lstm.gate_acts_bytes``, with fp32 or bf16 gates; with
    the tracer off nothing is recorded."""
    from dualvgr_tpu_torch.utils import trace

    want = 0
    trace.counters()  # what an earlier test left unread
    if on:
        trace.enable()
    try:
        for r, t, h, dtype in ((37, 5, 16, torch.float32), (256, 24, 384, torch.bfloat16)):
            xf, xb = _t(rs, cuda, t, r, 4 * h).to(dtype), _t(rs, cuda, t, r, 4 * h).to(dtype)
            wf, wb = _t(rs, cuda, h, 4 * h, scale=0.1), _t(rs, cuda, h, 4 * h, scale=0.1)
            acts = lstm_train_kernel.bilstm_train_fwd(xf, xb, wf, wb)[4]
            assert acts.dtype == torch.float32 and acts.shape == (2, t, r, 4 * h)
            want += 2 * t * r * 4 * h * 4
    finally:
        trace.disable()
    assert trace.counters() == ({"lstm.gate_acts_bytes": want} if on else {})


@pytest.mark.parametrize("r,t,h,with_outputs", [(37, 5, 16, True), (256, 24, 384, False)])
def test_train_kernels_keep_nan_padding_out_of_the_dgates(rs, cuda, r, t, h, with_outputs):
    """Gates that are NaN at every masked step: kernel 3 stores zero
    activations there, so kernel 4's m = 0 meets nothing non-finite and
    the dgates equal the plain pair's, zero at the masked steps."""
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g), _t(rs, cuda, t, r, g)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda)
    steps = torch.arange(t, device=cuda)[:, None]
    xf[steps >= lens[None, :]] = float("nan")
    xb[steps < t - lens[None, :]] = float("nan")
    got = lstm_train_kernel.bilstm_train_fwd(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    want = lstm_train_kernel.bilstm_train_fwd_reference(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    dfinal = _t(rs, cuda, r, 2 * h)
    douts = _t(rs, cuda, r, t, 2 * h) if with_outputs else None
    got = lstm_train_kernel.bilstm_train_bwd(got[4], wf, wb, lens, got[3], dfinal, douts)
    torch.cuda.synchronize()
    want = lstm_train_kernel.bilstm_train_bwd_reference(want[4], wf, wb, lens, want[3], dfinal, douts)
    for a, b, name in zip(got, want, ("dxf", "dxb")):
        assert torch.isfinite(a).all(), name
        _close(a, b, 1e-3, name)
    assert not got[0][steps >= lens[None, :]].any() and not got[1][steps < t - lens[None, :]].any()


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


@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (1, 2), (2, 1)])
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


# the train cells' R at T 16 (R*T 65,536, 32,768 -- msvd-qa's eval too --
# and 81,920), D 2,048 into 2 x 1,536 gate columns
K7_CELLS = {"msrvtt-qa": 4096, "msvd-qa": 2048, "svqa": 5120}


@pytest.mark.parametrize("cell", list(K7_CELLS))
def test_input_proj_f32_keeps_fp32_precision_at_the_cells_shapes(cuda, cell):
    rows = K7_CELLS[cell]
    args = f32_inputs(rows, torch.Generator(device=cuda).manual_seed(rows))
    want = fp64_product(*args)
    e_fp32, e_tf32 = baddbmm_errors(args, want)
    before = proj_kernel.input_proj_f32.launches
    trace.enable()
    got = proj_kernel.input_proj_f32(*args)
    torch.cuda.synchronize()
    trace.disable()
    assert proj_kernel.input_proj_f32.launches == before + 1
    assert trace.counters() == {"proj.tc_f32_rows": rows * 16}
    err = rel_error(got, want)
    assert err <= 2 * e_fp32, f"kernel 7 {err:.3e} against baddbmm's fp32 {e_fp32:.3e}"
    assert e_tf32 > 2 * e_fp32, f"baddbmm in TF32 {e_tf32:.3e} within the bound {2 * e_fp32:.3e}"


@pytest.mark.parametrize("r,t,d,g", [
    (37, 5, 72, 200),    # ragged M (185 rows), K not a multiple of 32, an N tile straddles the directions
    (3, 7, 36, 64),      # K of one and a bit k-blocks
    (1, 1, 4, 4),        # the least the kernel takes
    (130, 3, 100, 260),  # two M tiles, 4H not a multiple of 8
    (9, 16, 2048, 1536), # the cells' widths at few rows
])
def test_input_proj_f32_matches_fp64_on_ragged_shapes(cuda, r, t, d, g):
    args = f32_inputs(r, torch.Generator(device=cuda).manual_seed(r * t), t=t, d=d, g=g)
    want = fp64_product(*args)
    e_fp32, _ = baddbmm_errors(args, want)
    got = proj_kernel.input_proj_f32(*args)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.float32 and a.shape == (t, r, g) for a in got)
    err = rel_error(got, want)
    assert err <= max(2 * e_fp32, 1e-6), f"{err:.3e} against baddbmm's {e_fp32:.3e}"
    # both directions' time order: the forward's step t at t, the backward's at T-1-t
    x, w_f, b_f, w_b, b_b = (a.double() for a in args)
    for step in (0, t - 1):
        torch.testing.assert_close(got[0][step].double(), x[:, step] @ w_f.t() + b_f, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1][t - 1 - step].double(), x[:, step] @ w_b.t() + b_b, rtol=1e-5, atol=1e-5)


def test_input_proj_f32_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    w, b = torch.zeros(64, 40, device=cuda), torch.zeros(64, device=cuda)
    before = proj_kernel.input_proj_f32.launches
    with pytest.raises(TypeError):
        proj_kernel.input_proj_f32(torch.zeros(3, 4, 40, device=cuda, dtype=torch.bfloat16), w, b, w, b)
    with pytest.raises(ValueError, match="% 4"):
        w6 = torch.zeros(64, 42, device=cuda)
        proj_kernel.input_proj_f32(torch.zeros(3, 4, 42, device=cuda), w6, b, w6, b)
    with pytest.raises(ValueError, match="contiguous"):
        proj_kernel.input_proj_f32(torch.zeros(4, 3, 40, device=cuda).transpose(0, 1), w, b, w, b)
    with pytest.raises(ValueError, match="aligned"):
        proj_kernel.input_proj_f32(torch.zeros(3 * 4 * 40 + 1, device=cuda)[1:].view(3, 4, 40), w, b, w, b)
    with pytest.raises(RuntimeError, match="autograd"):
        proj_kernel.input_proj_f32(torch.zeros(3, 4, 40, device=cuda), w.clone().requires_grad_(), b, w, b)
    assert proj_kernel.input_proj_f32.launches == before


@pytest.mark.parametrize("cell", list(K7_CELLS))
def test_wgrad_f32_keeps_fp32_precision_at_the_cells_shapes(cuda, cell):
    """Kernel 8 summed over the cells' K = R*T (32,768 to 81,920): within
    twice the library SGEMMs' fp32 error against fp64, which TF32 is not;
    one launch, R*T rows counted."""
    rows = K7_CELLS[cell]
    args = wgrad_inputs(rows, torch.Generator(device=cuda).manual_seed(rows))
    want = fp64_wgrad(*args)
    e_fp32, e_tf32 = sgemm_errors(args, want)
    before = proj_kernel.input_proj_f32_wgrad.launches
    trace.enable()
    got = proj_kernel.input_proj_f32_wgrad(*args)
    torch.cuda.synchronize()
    trace.disable()
    assert proj_kernel.input_proj_f32_wgrad.launches == before + 1
    assert trace.counters() == {"proj.tc_f32_wgrad_rows": rows * 16}
    err = rel_error(got, want)
    assert err <= 2 * e_fp32, f"kernel 8 {err:.3e} against the SGEMMs' fp32 {e_fp32:.3e}"
    assert e_tf32 > 2 * e_fp32, f"the SGEMMs in TF32 {e_tf32:.3e} within the bound {2 * e_fp32:.3e}"


@pytest.mark.parametrize("r,t,d,g", [
    (37, 5, 72, 200),    # ragged R (a k-block of 5 rows a step), M and N tiles ragged
    (5, 7, 24, 40),      # R odd, under one k-block
    (33, 1, 8, 4),       # T 1, R one past a k-block, R_pad 36
    (1, 1, 4, 4),        # the least the kernel takes
    (130, 3, 100, 260),  # two M tiles a direction, 4H not a multiple of 8
    (9, 16, 2048, 1536), # the cells' widths at few rows
])
def test_wgrad_f32_matches_fp64_on_ragged_shapes(cuda, r, t, d, g):
    args = wgrad_inputs(r, torch.Generator(device=cuda).manual_seed(r * t), t=t, d=d, g=g)
    want = fp64_wgrad(*args)
    e_fp32, _ = sgemm_errors(args, want)
    got = proj_kernel.input_proj_f32_wgrad(*args)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.float32 and a.shape == (g, d) for a in got)
    err = rel_error(got, want)
    assert err <= max(2 * e_fp32, 1e-6), f"{err:.3e} against the SGEMMs' {e_fp32:.3e}"
    # the time order: the backward direction's kernel step s meets x at T-1-s
    x, dxf, dxb = (a.double() for a in args)
    want_b = sum(dxb[s].t() @ x[:, t - 1 - s] for s in range(t))
    torch.testing.assert_close(got[1].double(), want_b, rtol=1e-5, atol=1e-5 * want_b.abs().max().item())


def test_wgrad_f32_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dx = torch.zeros(3, 4, 40, device=cuda), torch.zeros(4, 3, 64, device=cuda)
    before = proj_kernel.input_proj_f32_wgrad.launches
    with pytest.raises(TypeError):
        proj_kernel.input_proj_f32_wgrad(x.to(torch.bfloat16), dx, dx)
    with pytest.raises(ValueError, match="% 4"):
        proj_kernel.input_proj_f32_wgrad(torch.zeros(3, 4, 42, device=cuda), dx, dx)
    with pytest.raises(ValueError, match="aligned"):
        proj_kernel.input_proj_f32_wgrad(x, torch.zeros(4 * 3 * 64 + 1, device=cuda)[1:].view(4, 3, 64), dx)
    with pytest.raises(ValueError, match="aligned"):
        proj_kernel.input_proj_f32_wgrad(torch.zeros(3 * 4 * 40 + 1, device=cuda)[1:].view(3, 4, 40), dx, dx)
    with pytest.raises(ValueError, match="contiguous"):
        proj_kernel.input_proj_f32_wgrad(x, torch.zeros(3, 4, 64, device=cuda).transpose(0, 1), dx)
    with pytest.raises(RuntimeError, match="autograd"):
        proj_kernel.input_proj_f32_wgrad(x, dx.clone().requires_grad_(), dx)
    assert proj_kernel.input_proj_f32_wgrad.launches == before


@pytest.mark.parametrize("cell", list(K7_CELLS))
def test_whh_grad_f32_keeps_fp32_precision_at_the_cells_shapes(cuda, cell):
    """Kernel 9 at the appearance BiLSTM's K = R*T of each train cell
    (32,768 to 81,920), H 384: within the library SGEMMs' fp32 error
    against fp64, which TF32 is not; one launch, R*T rows counted."""
    rows = K7_CELLS[cell]
    args = whh_inputs(rows, torch.Generator(device=cuda).manual_seed(rows))
    want = fp64_whh(*args)
    e_fp32, e_tf32 = whh_sgemm_errors(args, want)
    before = whh_grad_kernel.whh_grad_f32.launches
    trace.enable()
    got = whh_grad_kernel.whh_grad_f32(*args)
    torch.cuda.synchronize()
    trace.disable()
    assert whh_grad_kernel.whh_grad_f32.launches == before + 1
    assert trace.counters() == {"lstm.tc_f32_whh_rows": rows * 16}
    assert all(a.dtype == torch.float32 and a.shape == (384, 1536) for a in got)
    err = rel_error(got, want)
    assert err <= e_fp32, f"kernel 9 {err:.3e} against the SGEMMs' fp32 {e_fp32:.3e}"
    assert e_tf32 > 2 * e_fp32, f"the SGEMMs in TF32 {e_tf32:.3e} within {2 * e_fp32:.3e}"


@pytest.mark.parametrize("r,t,h", [
    (256, 24, 384),  # msrvtt-qa's and msvd-qa's question BiLSTMs
    (256, 40, 384),  # svqa's
    (37, 9, 100),    # R not a multiple of 4, H not of 128: ragged M and N tiles
])
def test_whh_grad_f32_matches_fp64_on_kernel_4s_ragged_dgates(rs, cuda, r, t, h):
    """On kernels 3 and 4's own hprev and dgates with ragged lengths (zero
    dgates at the masked steps): within the library SGEMMs' fp32 error, and
    each direction's gradient by the contract, in kernel time."""
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g), _t(rs, cuda, t, r, g)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda)
    _, outs, hprev, cprev, acts = lstm_train_kernel.bilstm_train_fwd(xf, xb, wf, wb, lens, with_outputs=True)
    dxf, dxb = lstm_train_kernel.bilstm_train_bwd(acts, wf, wb, lens, cprev, _t(rs, cuda, r, 2 * h),
                                                  _t(rs, cuda, r, t, 2 * h))
    args = (hprev, dxf, dxb)
    want = fp64_whh(*args)
    e_fp32, _ = whh_sgemm_errors(args, want)
    got = whh_grad_kernel.whh_grad_f32(*args)
    torch.cuda.synchronize()
    err = rel_error(got, want)
    assert err <= max(e_fp32, 1e-6), f"{err:.3e} against the SGEMMs' {e_fp32:.3e}"
    h64 = hprev.double()
    want_b = sum(h64[s, :, h:].t() @ dxb[s].double() for s in range(t))
    torch.testing.assert_close(got[1].double(), want_b, rtol=1e-5, atol=1e-5 * want_b.abs().max().item())


@pytest.mark.parametrize("r,t,h,splits", [
    (5, 7, 8, None),      # R odd, under one k-block
    (33, 1, 4, None),     # T 1, R one past a k-block, R_pad 36
    (1, 1, 1, None),      # the least the kernel takes
    (130, 3, 200, None),  # two M tiles a direction, two N tiles
    (64, 6, 384, 1),      # one split: the units do not fill the card
    (64, 6, 384, 12),     # every k-block its own split
])
def test_whh_grad_f32_matches_fp64_on_small_shapes(cuda, r, t, h, splits):
    args = whh_inputs(r, torch.Generator(device=cuda).manual_seed(r * t + h), t=t, h=h)
    want = fp64_whh(*args)
    e_fp32, _ = whh_sgemm_errors(args, want)
    got = whh_grad_kernel._whh_cuda(*args, splits=splits)
    torch.cuda.synchronize()
    assert all(a.dtype == torch.float32 and a.shape == (h, 4 * h) for a in got)
    err = rel_error(got, want)
    assert err <= max(e_fp32, 1e-6), f"{err:.3e} against the SGEMMs' {e_fp32:.3e}"


def test_whh_grad_f32_gives_the_same_bits_on_every_run(cuda):
    """The splits are summed in a fixed order: one input, the same bits,
    at the cells' split count and at another."""
    args = whh_inputs(4096, torch.Generator(device=cuda).manual_seed(1))
    first = whh_grad_kernel.whh_grad_f32(*args)
    for _ in range(3):
        again = whh_grad_kernel.whh_grad_f32(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    other = whh_grad_kernel._whh_cuda(*args, splits=5)
    assert all(torch.equal(a, b) for a, b in zip(other, whh_grad_kernel._whh_cuda(*args, splits=5)))


def test_whh_grad_f32_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    hprev, dx = torch.zeros(4, 3, 16, device=cuda), torch.zeros(4, 3, 32, device=cuda)
    before = whh_grad_kernel.whh_grad_f32.launches
    with pytest.raises(TypeError):
        whh_grad_kernel.whh_grad_f32(hprev.to(torch.bfloat16), dx, dx)
    with pytest.raises(ValueError, match="shape"):
        whh_grad_kernel.whh_grad_f32(hprev, torch.zeros(4, 3, 36, device=cuda), dx)
    with pytest.raises(ValueError, match="aligned"):
        whh_grad_kernel.whh_grad_f32(hprev, torch.zeros(4 * 3 * 32 + 1, device=cuda)[1:].view(4, 3, 32), dx)
    with pytest.raises(ValueError, match="contiguous"):
        whh_grad_kernel.whh_grad_f32(torch.zeros(3, 4, 16, device=cuda).transpose(0, 1), dx, dx)
    with pytest.raises(RuntimeError, match="autograd"):
        whh_grad_kernel.whh_grad_f32(hprev, dx.clone().requires_grad_(), dx)
    with pytest.raises(RuntimeError, match="cudaError 1"):  # more splits than k-blocks
        whh_grad_kernel._whh_cuda(hprev, dx, dx, splits=5)
    assert whh_grad_kernel.whh_grad_f32.launches == before


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


@pytest.mark.parametrize("r,t,h", [(37, 5, 16), (1100, 6, 384), (1, 7, 100), (4096, 16, 384)])
def test_train_kernels_with_bf16_gates_match_plain(rs, cuda, r, t, h):
    """The appearance op's shape: full length, final only, bf16 gates; the
    outputs and the dgates stay fp32."""
    g = 4 * h
    xf, xb = _t(rs, cuda, t, r, g).to(torch.bfloat16), _t(rs, cuda, t, r, g).to(torch.bfloat16)
    wf, wb = _t(rs, cuda, h, g, scale=0.1), _t(rs, cuda, h, g, scale=0.1)
    got = lstm_train_kernel.bilstm_train_fwd(xf, xb, wf, wb)
    torch.cuda.synchronize()
    want = lstm_train_kernel.bilstm_train_fwd_reference(xf, xb, wf, wb)
    for a, b, name in zip(got, want, ("final", "outs", "hprev", "cprev", "acts")):
        if b is None:
            continue
        assert a.dtype == torch.float32, name
        _close(a, b, 1e-4, name)
    dfinal = _t(rs, cuda, r, 2 * h)
    got = lstm_train_kernel.bilstm_train_bwd(got[4], wf, wb, None, got[3], dfinal)
    torch.cuda.synchronize()
    want = lstm_train_kernel.bilstm_train_bwd_reference(want[4], wf, wb, None, want[3], dfinal)
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


def test_build_model_refuses_dims_the_kernels_cannot_take(rs, cuda):
    """On the card a model whose dims a kernel cannot take is refused when
    it is built, naming the limit and the plain path; with kernels off the
    same dims run a forward."""
    dims = dict(vision_dim=64, module_dim=1024, word_dim=16, question_vocab_size=40, num_answers=30,
                num_of_nodes=6, graph_layers=1, unit_layers=1)
    with pytest.raises(ValueError, match="use_pallas: false") as err:
        build_model(device=cuda, **dims)
    assert "BiLSTM" in str(err.value) and "graph-cycle" in str(err.value)
    model = build_model(device=cuda, use_kernels=False, **dims)
    b, t = 3, 5
    qlen = torch.from_numpy(rs.randint(1, t + 1, (b,)).astype(np.int32)).to(cuda)
    q = torch.from_numpy(rs.randint(1, 40, (b, t)).astype(np.int32)).to(cuda)
    out = model(_t(rs, cuda, b, 6, 4, 64), _t(rs, cuda, b, 6, 64), q, qlen)
    assert out.logits.shape == (b, 30) and torch.isfinite(out.logits).all()


def _memory_loader(tmp_path, videos=40, questions=70, batch=8, shuffle=False, prefetch=2):
    """A VideoQADataLoader on in-memory FeatureStores (no HDF5), its batches
    pinned: a vocab, one question pickle, and features whose every row is
    distinct. Returns (loader, appearance store, motion store)."""
    import json
    import pickle

    from dualvgr_tpu_torch.data import FeatureStore, VideoQADataLoader

    rs = np.random.RandomState(5)
    ids = np.arange(100, 100 + videos)
    app = FeatureStore.from_array(ids, rs.randn(videos, 4, 3, 256).astype(np.float32), "resnet_features")
    mot = FeatureStore.from_array(ids, rs.randn(videos, 4, 256).astype(np.float32), "resnext_features")
    vocab = {"question_token_to_idx": {"<NULL>": 0, "<UNK>": 1, **{f"w{i}": i for i in range(2, 20)}},
             "answer_token_to_idx": {f"a{i}": i for i in range(6)}, "question_answer_token_to_idx": {}}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    qlen = rs.randint(1, 7, questions)
    obj = {"questions": rs.randint(2, 20, (questions, 6)) * (np.arange(6)[None] < qlen[:, None]),
           "questions_len": qlen, "question_id": np.arange(questions), "video_ids": rs.choice(ids, questions),
           "answers": rs.randint(0, 6, questions)}
    with open(tmp_path / "q.pt", "wb") as f:
        pickle.dump(obj, f)
    loader = VideoQADataLoader(question_pt=str(tmp_path / "q.pt"), vocab_json=str(tmp_path / "vocab.json"),
                               appearance_feat=app, motion_feat=mot, batch_size=batch, shuffle=shuffle,
                               prefetch=prefetch, pin_memory=True)
    return loader, app, mot


def _device_items(loader):
    for b in loader:
        yield (b.appearance_feat, b.motion_feat, b.question, b.question_len, b.answer, b.valid, b.video_idx)


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_to_device_yields_the_host_batches(cuda, tmp_path, size):
    """An epoch through ``prefetch_to_device`` gives, on the card, exactly
    the loader's host batches (pinned features, numpy fields)."""
    from dualvgr_tpu_torch.parallel.mesh import prefetch_to_device

    loader, _, _ = _memory_loader(tmp_path)
    host = []
    for item in _device_items(loader):
        assert item[0].is_pinned() and item[1].is_pinned()
        host.append(tuple(torch.as_tensor(x).clone() for x in item))
    got = list(prefetch_to_device(_device_items(loader), cuda, size))
    assert len(got) == len(host) == len(loader)
    for g, h in zip(got, host):
        assert all(x.device.type == "cuda" for x in g)
        assert all(x.dtype == y.dtype and torch.equal(x.cpu(), y) for x, y in zip(g, h))


def test_prefetch_traces_each_copy_and_counts_its_bytes(cuda, tmp_path):
    """With the tracer on, ``prefetch_to_device`` records one
    ``prefetch.copy`` an item on the calling thread, counts the bytes it
    issues and pins each pageable leaf (the numpy fields) on the way."""
    import threading

    from dualvgr_tpu_torch.parallel.mesh import prefetch_to_device
    from dualvgr_tpu_torch.utils import trace

    loader, _, _ = _memory_loader(tmp_path)
    host = [tuple(torch.as_tensor(x) for x in item) for item in _device_items(loader)]
    trace.enable()
    try:
        got = list(prefetch_to_device(_device_items(loader), cuda, 2))
    finally:
        trace.disable()
    spans, counters = trace.spans(), trace.counters()
    copies = [s for s in spans if s.name == "prefetch.copy"]
    assert len(got) == len(copies) == len(loader)
    assert all(s.thread == threading.get_ident() and s.parent is None for s in copies)
    assert counters["prefetch.bytes"] == sum(x.nbytes for item in host for x in item)
    assert counters["prefetch.pinned"] == 5 * len(loader)  # question, qlen, answer, valid, video ids


def test_prefetch_never_rewrites_a_pinned_batch_under_its_copy(cuda, tmp_path):
    """Stress: a fast producer and a slow consumer (the compute stream kept
    busy, the host sleeping) over several shuffled epochs with copies in
    flight; every batch on the card equals its rows gathered afresh from
    the store, so no pinned buffer was reused before its copy was done and
    no device buffer before its consumer was."""
    import sys
    import time

    from dualvgr_tpu_torch.parallel.mesh import prefetch_to_device

    loader, app, mot = _memory_loader(tmp_path, videos=64, questions=200, batch=16, shuffle=True, prefetch=4)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n = 0
        for _ in range(3):
            for a, m, *_, vids in prefetch_to_device(_device_items(loader), cuda, 3):
                torch.cuda._sleep(2_000_000)  # keep the compute stream busy past the next copies
                time.sleep(0.002)
                a_sum, m_sum = a.sum(dtype=torch.float64), m.sum(dtype=torch.float64)  # read on the compute stream
                vids = vids.cpu().numpy()
                want_a = app.gather(app.rows_for_video_ids(vids))
                want_m = mot.gather(mot.rows_for_video_ids(vids))
                assert torch.equal(a.cpu(), want_a) and torch.equal(m.cpu(), want_m)
                assert a_sum.item() == want_a.to(cuda).sum(dtype=torch.float64).item()
                assert m_sum.item() == want_m.to(cuda).sum(dtype=torch.float64).item()
                n += 1
        assert n == 3 * len(loader)
    finally:
        sys.setswitchinterval(interval)


def test_custom_ops_on_the_card_match_their_plain_versions(rs, cuda):
    """The three custom ops called through ``torch.ops.dualvgr_torch``, as a
    loaded export calls them: each launches its kernel once and matches its
    plain version; the graph cycle reads a stride-0 ``scores`` through its
    strides (the tolerances of the wrapper tests above)."""
    ops = torch.ops.dualvgr_torch
    r, t, h = 37, 6, 64
    xf, xb = _t(rs, cuda, t, r, 4 * h), _t(rs, cuda, t, r, 4 * h)
    wf, wb = _t(rs, cuda, h, 4 * h, scale=0.1), _t(rs, cuda, h, 4 * h, scale=0.1)
    lens = torch.from_numpy(rs.randint(1, t + 1, (r,)).astype(np.int32)).to(cuda)
    n0 = lstm_kernel.bilstm_recurrence.launches
    final, outs = ops.bilstm_recurrence(xf, xb, wf, wb, lens, True)
    final_only, empty = ops.bilstm_recurrence(xf, xb, wf, wb, None, False)
    torch.cuda.synchronize()
    assert lstm_kernel.bilstm_recurrence.launches == n0 + 2 and empty.numel() == 0
    want_final, want_outs = lstm_kernel.bilstm_recurrence_reference(xf, xb, wf, wb, lens, with_outputs=True)
    assert (final - want_final).abs().max().item() <= 1e-4 and (outs - want_outs).abs().max().item() <= 1e-4
    assert (final_only - lstm_kernel.bilstm_recurrence_reference(xf, xb, wf, wb)).abs().max().item() <= 1e-4

    hh, scores, args = _gat_inputs(rs, cuda, 32, 16, 768, 4, True)
    assert scores.stride()[-1] == 0
    n0 = gat_kernel.gat_cycle.launches
    got = ops.gat_cycle(hh, scores, *args)
    torch.cuda.synchronize()
    assert gat_kernel.gat_cycle.launches == n0 + 1
    for a, want in zip(got, gat_kernel.gat_cycle_reference(hh, scores, *args)):
        assert (a - want).abs().max().item() <= 1e-3 * max(1.0, want.abs().max().item())

    x = _t(rs, cuda, 64, 16, 2048)
    w_f, w_b = _t(rs, cuda, 1536, 2048, scale=0.02), _t(rs, cuda, 1536, 2048, scale=0.02)
    b_f, b_b = _t(rs, cuda, 1536), _t(rs, cuda, 1536)
    n0 = (proj_kernel.input_proj_both.launches, proj_kernel.tanh_to_bf16.launches)
    got = ops.input_proj_both(x, w_f, b_f, w_b, b_b, True)
    torch.cuda.synchronize()
    assert (proj_kernel.input_proj_both.launches, proj_kernel.tanh_to_bf16.launches) == (n0[0] + 1, n0[1] + 1)
    share = max(2e-3, 4 / (16 * 64 * 1536))
    for a, want, name in zip(got, proj_kernel.input_proj_both_reference(x, w_f, b_f, w_b, b_b), ("xf", "xb")):
        _close_bf16(a, want, 1e-5, f"custom op kernel 6 {name}", share)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_artifact_launches_the_kernels(rs, cuda, tmp_path, compute_dtype):
    """An artifact exported for cuda and loaded back runs kernels 1 and 2
    (and 6 with its tanh pass in bf16) at the eval forward's counts per
    call, and answers as the live predict fn does (ids equal, scores within
    1e-6); through a one-replica ReplicatedEngine on cuda:0 too."""
    from dualvgr_tpu_torch import ReplicatedEngine, build_predict_fn
    from dualvgr_tpu_torch import export as texport
    from dualvgr_tpu_torch.serving import per_device_predict_fns

    model = build_model(device=cuda, vision_dim=64, module_dim=64, word_dim=16, question_vocab_size=40,
                        num_answers=30, num_of_nodes=6, graph_layers=1, unit_layers=1, compute_dtype=compute_dtype)
    b, t, k = 8, 9, 5
    payload, meta = texport.export_serving(model, max_batch=b, app_shape=(6, 4, 64), mot_shape=(6, 64),
                                           max_q_len=t, top_k=k, platforms=("cuda",))
    path = str(tmp_path / "card.dvgr")
    texport.save_artifact(path, payload, meta)
    ops = texport.graph_ops(texport.load_artifact(path, cuda)[0].program)
    assert ops["dualvgr_torch.bilstm_recurrence.default"] == 3 and ops["dualvgr_torch.gat_cycle.default"] == 2
    assert ops["dualvgr_torch.input_proj_both.default"] == (compute_dtype == "bfloat16")
    predict, _ = texport.load_artifact(path, device=cuda)
    app, mot = rs.randn(b, 6, 4, 64).astype(np.float32), rs.randn(b, 6, 64).astype(np.float32)
    qlen = rs.randint(1, t + 1, (b,)).astype(np.int32)
    q = rs.randint(1, 40, (b, t)).astype(np.int32) * (np.arange(t)[None] < qlen[:, None])
    kernels = (lstm_kernel.bilstm_recurrence, gat_kernel.gat_cycle, proj_kernel.input_proj_both,
               proj_kernel.tanh_to_bf16)
    n0 = [f.launches for f in kernels]
    ids, scores = predict(app, mot, q, qlen)
    bf16 = int(compute_dtype == "bfloat16")
    assert [f.launches - n for f, n in zip(kernels, n0)] == [3, 2, bf16, bf16]
    live_ids, live_scores = build_predict_fn(model, k, device=cuda)(app, mot, q, qlen)
    np.testing.assert_array_equal(ids, live_ids)
    np.testing.assert_allclose(scores, live_scores, rtol=0, atol=1e-6)

    for source in (path, model):  # replicas from the artifact and from the model's weights
        fns = per_device_predict_fns(source, k, devices=["cuda:0"])
        with ReplicatedEngine(fns, devices=["cuda:0"], max_batch=b, max_q_len=t,
                              feature_shapes=((6, 4, 64), (6, 64))) as eng:
            out = [eng.submit(app[i], mot[i], q[i, : qlen[i]]) for i in range(3)]
            stats = eng.stats()
        assert stats["replicas"] == 1 and stats["requests"] == 3
        for i, (got_ids, got_scores) in enumerate(out):
            # alone in a padded batch, the row's scores are those of the full batch
            np.testing.assert_array_equal(got_ids, ids[i])
            np.testing.assert_allclose(got_scores, scores[i], rtol=0, atol=1e-6)


# ---- the path from decoded frames (no hand-written kernel: cuDNN's convs,
# the resize's float64 products, the native host gather)


@pytest.mark.parametrize("kind", ["appearance", "motion"])
def test_backbones_on_the_card_match_the_cpu_in_fp32(cuda, kind):
    """The fp32 extractors (TF32 off inside, channels-last on the card) at
    ``layers=(1, 1, 1, 1)`` against the same weights on the CPU, within
    1e-4 x max|ref|; the cuDNN TF32 flag as the extractor found it after."""
    from dualvgr_tpu_torch.preprocess.features import build_appearance_extractor, build_motion_extractor

    build = build_appearance_extractor if kind == "appearance" else build_motion_extractor
    shape = (4, 3, 64, 64) if kind == "appearance" else (3, 3, 16, 48, 48)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(0)) * 255
    ref = build(device="cpu", layers=(1, 1, 1, 1))(x)
    torch.backends.cudnn.allow_tf32 = True
    got = build(device=cuda, layers=(1, 1, 1, 1))(x.to(cuda))
    assert torch.backends.cudnn.allow_tf32 is True
    torch.backends.cudnn.allow_tf32 = False
    assert got.dtype == torch.float32 and got.shape == ref.shape == (shape[0], 2048)
    assert (got.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def test_the_resize_on_the_card_is_the_cpus(cuda):
    """PIL's bicubic resize on the card: bit for bit the CPU's (float64
    sums of integers below 2^53 in any order)."""
    from dualvgr_tpu_torch.preprocess.resize import resize_bicubic

    frames = torch.randint(0, 256, (6, 3, 240, 320), dtype=torch.uint8, generator=torch.Generator().manual_seed(1))
    for size in ((224, 224), (112, 112), (300, 400)):
        want = resize_bicubic(frames, size)
        got = resize_bicubic(frames.to(cuda), size)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_native_gather_fills_a_pinned_batch(cuda, dtype):
    """The native gather into a pinned tensor (as the loader fills a batch)
    is bit for bit ``index_select``; the batch copies to the card intact."""
    from dualvgr_tpu_torch.data import native

    src = torch.randn(300, 4, 2048).to(dtype)
    rows = np.random.RandomState(2).randint(0, 300, 256)
    pinned = torch.empty((256, 4, 2048), dtype=dtype, pin_memory=True)
    for n_threads in (1, 8):
        out = native.gather_rows(src, rows, out=pinned, n_threads=n_threads)
        assert out.data_ptr() == pinned.data_ptr() and out.is_pinned()
        assert torch.equal(out, native.gather_rows_reference(src, rows))
        assert torch.equal(out.to(cuda, non_blocking=True).cpu(), out)
    with pytest.raises(ValueError):
        native.gather_rows(src.to(cuda), rows)


def test_two_gloo_ranks_on_the_card_match_one_process(cuda):
    """Data parallel over two gloo ranks on cuda:0 (NCCL refuses two ranks
    on one device), kernels on: each step's loss, the updated-parameter
    checksum and the eval step's predictions against one process's step on
    the same global batches, the second with 3 of 8 rows padded (the fp32
    train limits: 1e-4 relative); kernels 3, 4 and 9 launch 3 times a step
    on each rank and kernels 7 and 8 once, kernels 1 and 2 three and two
    times an eval forward and kernel 7 once."""
    from dualvgr_tpu_torch.parallel import dryrun

    batches = dryrun.tiny_batches(1, seed=11) + dryrun.tiny_batches(1, seed=12, pad=3)
    spec = dict(device="cuda", batches=batches, eval=True, tpu=dict(use_pallas=True))
    one = dryrun.run_steps(spec)
    ranks = [r[0] for r in dryrun.spawn(dryrun.steps_on_rank, 2, ([spec],), device="cuda", timeout=300)]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-4)
        np.testing.assert_allclose(r["checksum"], one["checksum"], rtol=1e-4)
        np.testing.assert_array_equal(r["preds"], one["preds"])
        assert r["launches_train"] == (0, 0, 6, 6, 0, 0, 0, 2, 2, 6) == one["launches_train"]
        assert r["launches_eval"] == (3, 2, 0, 0, 0, 0, 0, 1, 0, 0) == one["launches_eval"]
