"""The port's zoos against the JAX package's, on the CPU.

Every class of the attention zoo, the graph zoo, the model-utils zoo, the
decoder variants and the question-encoder variants: the flax module is
initialised, every parameter redrawn from numpy (so no bias sits at
zero), the params carried onto the port's module by
``utils/weights.py::load_flax_params``, and the same numpy inputs go
through both in eval mode. Outputs agree within 1e-5 (fp32; the
BiLSTM-based encoders within 1e-5 too, the sums being short). The helper
functions (``construct_graph``, ``process_adj``, ``mean_x``, ``pca``,
``l2norm``) are held against theirs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvgr_tpu.models import attention_zoo as JA
from dualvgr_tpu.models import decoder as JD
from dualvgr_tpu.models import encoders as JE
from dualvgr_tpu.models import graph_zoo as JG
from dualvgr_tpu.models import utils_zoo as JU
from dualvgr_tpu.models.graph import dense_self_loop_adjacency
from dualvgr_tpu_torch.models import attention_zoo as PA
from dualvgr_tpu_torch.models import decoder as PD
from dualvgr_tpu_torch.models import encoders as PE
from dualvgr_tpu_torch.models import graph_zoo as PG
from dualvgr_tpu_torch.models import utils_zoo as PU
from dualvgr_tpu_torch.utils.weights import load_flax_params

ATOL = RTOL = 1e-5


def randomized(variables, seed=0, scale=0.3):
    """``variables`` with every param redrawn from numpy; batch statistics
    redrawn too (variances kept positive)."""
    rng = np.random.RandomState(seed)
    out = {"params": jax.tree_util.tree_map(
        lambda x: (rng.randn(*np.shape(x)) * scale).astype(np.float32), variables.get("params", {}))}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map(
            lambda x: (rng.rand(*np.shape(x)) + 0.5).astype(np.float32), variables["batch_stats"])
    return out


def to_torch(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def assert_tree_close(got, want, name):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{name}[{i}]")
        return
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    assert np.isfinite(w).all(), name
    np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def run_pair(fmod, pmod, args, fkw=None, pkw=None, extra=None, seed=0):
    """flax ``fmod`` and the port's ``pmod`` on the same numpy ``args``, with
    the flax params (randomized) carried across. Returns (port output,
    flax output, the port module)."""
    fkw = fkw or {}
    variables = fmod.init({"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
                          *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **fkw)
    variables = randomized(variables, seed)
    want = fmod.apply(variables, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **fkw)
    pmod.load_state_dict(load_flax_params(pmod, variables["params"], variables.get("batch_stats"), extra),
                         strict=True)
    pmod.eval()
    with torch.no_grad():
        got = pmod(*[to_torch(a) for a in args], **(pkw or {}))
    return got, want, pmod


def f32(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _tokens(rng, b=3, t=6, vocab=20):
    qlen = rng.randint(1, t + 1, (b,)).astype(np.int32)
    qlen[0] = t
    q = rng.randint(1, vocab, (b, t)).astype(np.int32)
    for i in range(b):
        q[i, qlen[i]:] = 0
    return q, qlen


def _mha_mask(b, lq, lk):
    m = np.zeros((b, lq, lk), bool)
    m[:, :, 0] = True
    return m


# name -> (flax module, port module, inputs from rng, flax call kwargs)
CASES = {
    "ScaledDotProductAttention": (
        lambda: JA.ScaledDotProductAttention(temperature=8 ** 0.5),
        lambda: PA.ScaledDotProductAttention(temperature=8 ** 0.5),
        lambda r: (f32(r, 3, 5, 8), f32(r, 3, 7, 8), f32(r, 3, 7, 6), _mha_mask(3, 5, 7)), {}),
    "MultiHeadAttention": (
        lambda: JA.MultiHeadAttention(n_head=4, d_model=16, d_k=8, d_v=6),
        lambda: PA.MultiHeadAttention(4, 16, 8, 6),
        lambda r: (f32(r, 2, 6, 16), f32(r, 2, 6, 16), f32(r, 2, 6, 16), _mha_mask(2, 6, 6)), {}),
    "PositionwiseFeedForward": (
        lambda: JA.PositionwiseFeedForward(16, 32), lambda: PA.PositionwiseFeedForward(16, 32),
        lambda r: (f32(r, 2, 5, 16),), {}),
    "EncoderLayer": (
        lambda: JA.EncoderLayer(d_model=16, d_inner=32, n_head=2, d_k=8, d_v=8),
        lambda: PA.EncoderLayer(16, 32, 2, 8, 8),
        lambda r: (*(f32(r, 2, 5, 16),) * 3, (np.arange(5)[None, :, None] < np.array([5, 3])[:, None, None])
                   .astype(np.float32), _mha_mask(2, 5, 5)), {}),
    "AttentionC": (
        lambda: JA.AttentionC(dim=20, num_hid=12, head=4), lambda: PA.AttentionC(20, 12, head=4),
        lambda r: (f32(r, 3, 1, 12), f32(r, 3, 20)), {}),
    "RNNEncoder": (
        lambda: JA.RNNEncoder(word_size=10, hidden_size=6, n_layers=2),
        lambda: PA.RNNEncoder(10, 6, n_layers=2),
        lambda r: (f32(r, 4, 7, 10), np.array([7, 3, 1, 0], np.int32)), {}),
    "RNNEncoder_unidirectional": (
        lambda: JA.RNNEncoder(word_size=10, hidden_size=6, bidirectional=False, n_layers=2),
        lambda: PA.RNNEncoder(10, 6, bidirectional=False, n_layers=2),
        lambda r: (f32(r, 4, 7, 10), np.array([7, 3, 1, 0], np.int32)), {}),
    "TanhAttention": (
        lambda: JA.TanhAttention(8), lambda: PA.TanhAttention(8),
        lambda r: (f32(r, 2, 5, 8), f32(r, 2, 4, 8)), {}),
    "TanhAttention_forward": (
        lambda: JA.TanhAttention(8, direction="forward"), lambda: PA.TanhAttention(8, direction="forward"),
        lambda r: (f32(r, 2, 5, 8), f32(r, 2, 5, 8), np.array([[1, 1, 1, 1, 0], [1] * 5], np.int32)), {}),
    "TanhAttention_backward": (
        lambda: JA.TanhAttention(8, direction="backward"), lambda: PA.TanhAttention(8, direction="backward"),
        lambda r: (f32(r, 2, 5, 8), f32(r, 2, 5, 8), np.array([[1, 1, 1, 1, 0], [1] * 5], np.int32)), {}),
    "WordAttention": (
        lambda: JA.WordAttention(8), lambda: PA.WordAttention(8),
        lambda r: (f32(r, 3, 6, 8), f32(r, 3, 6, 5), _tokens(r, 3, 6)[0]), {}),
    "GatedNLT": (lambda: JA.GatedNLT(10, 6), lambda: PA.GatedNLT(10, 6), lambda r: (f32(r, 4, 10),), {}),
    "GAT": (
        lambda: JG.GAT(n_heads=4, head_dim=4, in_dim=16), lambda: PG.GAT(4, 4, 16),
        lambda r: (f32(r, 3, 5, 16), np.asarray(dense_self_loop_adjacency(5))), {}),
    "GINLayer": (
        lambda: JG.GINLayer(input_dim=8, proj_dim=8, num_hop=2, num_rel=3),
        lambda: PG.GINLayer(8, 8, num_hop=2, num_rel=3),
        lambda r: (f32(r, 2, 4, 8), np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32),
                   r.rand(2, 3, 4, 4).astype(np.float32)), {}),
    "GatedGATLayer": (
        lambda: JG.GatedGATLayer(input_dim=8, proj_dim=8, num_hop=2, num_rel=2),
        lambda: PG.GatedGATLayer(8, 8, num_hop=2, num_rel=2),
        lambda r: (f32(r, 2, 4, 8), np.array([[1, 1, 1, 1], [1, 1, 1, 0]], np.float32),
                   (r.rand(2, 2, 4, 4) * (r.rand(2, 2, 4, 4) > 0.3)).astype(np.float32)), {}),
    "GatedGCNLayer": (
        lambda: JG.GatedGCNLayer(input_dim=8, proj_dim=8, num_hop=3, num_rel=2),
        lambda: PG.GatedGCNLayer(8, 8, num_hop=3, num_rel=2),
        lambda r: (f32(r, 2, 4, 8), r.rand(2, 2, 4, 4).astype(np.float32)), {}),
    "ConcatELUAttn": (
        lambda: JD.ConcatELUAttn(module_dim=16), lambda: PD.ConcatELUAttn(16),
        lambda r: (f32(r, 3, 16), f32(r, 3, 5, 16)), {}),
    "MFBAttn": (
        lambda: JD.MFBAttn(module_dim=16), lambda: PD.MFBAttn(16),
        lambda r: (f32(r, 3, 16), f32(r, 3, 5, 16)), {}),
    "SimpleConcatELUAttn": (
        lambda: JD.SimpleConcatELUAttn(module_dim=16), lambda: PD.SimpleConcatELUAttn(16),
        lambda r: (f32(r, 3, 16), f32(r, 3, 5, 16)), {}),
    "GateOutputUnitOpenEnded": (
        lambda: JD.GateOutputUnitOpenEnded(module_dim=16, num_answers=7),
        lambda: PD.GateOutputUnitOpenEnded(16, 7),
        lambda r: (f32(r, 4, 16), f32(r, 4, 16)), {"train": False}),
    "SimpleQuestionEncoder": (
        lambda: JE.SimpleQuestionEncoder(20, word_dim=10, module_dim=16),
        lambda: PE.SimpleQuestionEncoder(20, 10, 16),
        lambda r: _tokens(r), {"train": False}),
    "MultiGranularQuestionEncoder": (
        lambda: JE.MultiGranularQuestionEncoder(20, word_dim=10, module_dim=12),
        lambda: PE.MultiGranularQuestionEncoder(20, 10, 12),
        lambda r: _tokens(r), {"train": False}),
    "VisualEnhanceByQuery": (
        lambda: JU.VisualEnhanceByQuery(module_dim=16), lambda: PU.VisualEnhanceByQuery(16),
        lambda r: (f32(r, 2, 6, 16), f32(r, 2, 4, 16)), {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_zoo_class_matches_flax(name):
    fmake, pmake, make_inputs, fkw = CASES[name]
    args = make_inputs(np.random.RandomState(0))
    got, want, _ = run_pair(fmake(), pmake(), args, fkw)
    assert_tree_close(got, want, name)


def test_construct_graph_matches_jax(rng):
    feats = rng.randn(9, 12).astype(np.float32)
    for topk in (0, 2, 8, 20):
        got = PG.construct_graph(torch.from_numpy(feats), topk)
        np.testing.assert_array_equal(got.numpy(), np.asarray(JG.construct_graph(feats, topk)))
        assert got.dtype == torch.float32


def test_process_adj_matches_jax(rng):
    a = (rng.rand(6, 6) > 0.5).astype(np.float32)
    a[0, 1] = 0.5  # not an exact 1: no degree
    got = PG.process_adj(a)
    for g, w in zip(got, JG.process_adj(a)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_model_utils_match_jax(rng):
    x = np.concatenate([rng.randn(50, 1) * 10.0, 0.1 * rng.randn(50, 3)], axis=1)
    np.testing.assert_array_equal(PU.mean_x(x), JU.mean_x(x))
    for k in (1, 3):
        got, want = PU.pca(x, k), JU.pca(x, k)
        # eigenvectors are defined up to sign
        np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError):
        PU.pca(x, 9)
    y = rng.randn(2, 3, 8).astype(np.float32)
    y[0, 0] = 0.0  # a zero row stays finite
    np.testing.assert_allclose(PU.l2norm(torch.from_numpy(y)).numpy(), np.asarray(JU.l2norm(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)


def test_zoo_trains_with_dropout():
    """In training mode the zoo's dropout sites draw from the generator:
    a replay from the same seed gives the same output, another seed another,
    and the gradients reach every parameter."""
    m = PA.EncoderLayer(16, 32, 2, 8, 8, dropout=0.5).train()
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(0))
    outs = [m(x, x, x, generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    outs[0].sum().backward()
    assert all(p.grad is not None for p in m.parameters())


def test_zoo_check_runs_every_case_on_the_cpu():
    """The card's zoo check (``bench/zoo_check.py``, phase ``zoo`` of
    chip_smoke.py) runs every case; on the CPU against itself, exactly."""
    from dualvgr_tpu_torch.bench.zoo_check import CASES, check_zoo

    errs = check_zoo("cpu")
    assert sorted(errs) == sorted(CASES) and max(errs.values()) == 0.0
    # every class of the zoos has a case
    for mod, names in ((PA, ("ScaledDotProductAttention", "MultiHeadAttention", "PositionwiseFeedForward",
                             "EncoderLayer", "AttentionC", "RNNEncoder", "TanhAttention", "WordAttention",
                             "GatedNLT")),
                       (PG, ("GAT", "GINLayer", "GatedGATLayer", "GatedGCNLayer", "construct_graph", "process_adj")),
                       (PD, ("ConcatELUAttn", "MFBAttn", "SimpleConcatELUAttn", "GateOutputUnitOpenEnded")),
                       (PE, ("SimpleQuestionEncoder", "MultiGranularQuestionEncoder")),
                       (PU, ("VisualEnhanceByQuery", "l2norm"))):
        for n in names:
            assert f"{mod.__name__.split('.')[-1]}.{n}" in CASES, n
