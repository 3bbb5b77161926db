"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels have
no CPU mode; on a CPU tensor the wrappers run the plain version, which the
CPU tests hold against the JAX package). The file imports neither JAX nor
the JAX package, so on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

fp32 throughout, TF32 off. Tolerances: recurrence 1e-4 absolute; graph
cycle and model outputs 1e-3 * max(1, max|ref|) (fp32 sums in another
order).
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.ops import gat_kernel, lstm_kernel

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
