"""The port's full eval forward against the JAX package's flax DualVGR.

Same randomized weights (every leaf drawn from numpy, so no bias or
batch-norm statistic sits at its init value) and the same numpy inputs
through flax ``apply(train=False)`` (XLA path) and the port on the CPU,
with the kernel routing on and off. Logits and all six auxiliary outputs
agree at atol 1e-4 (fp32; the errors of the encoders, graph cycles and
classifier add up through the stack).
"""

import functools

import numpy as np
import pytest
import torch

import jax

from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.utils.weights import from_jax_variables

ATOL = 1e-4
VOCAB, ANSWERS, VISION, T = 30, 9, 20, 6


def dims(unit_layers, graph_layers, nodes):
    return dict(
        vision_dim=VISION, module_dim=16, word_dim=10, question_vocab_size=VOCAB,
        num_answers=ANSWERS, num_of_nodes=nodes, graph_layers=graph_layers,
        unit_layers=unit_layers,
    )


def inputs(nodes, b=4, f=3, seed=0):
    rng = np.random.RandomState(seed)
    app = rng.randn(b, nodes, f, VISION).astype(np.float32)
    mot = rng.randn(b, nodes, VISION).astype(np.float32)
    qlen = rng.randint(1, T + 1, (b,)).astype(np.int32)
    qlen[0] = 1
    q = rng.randint(1, VOCAB, (b, T)).astype(np.int32)
    for i in range(b):
        q[i, qlen[i]:] = 0
    return app, mot, q, qlen


def random_variables(model, example, seed=0):
    """flax variables with every leaf redrawn from numpy (running variances
    kept positive)."""
    variables = model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(0)},
        *example, train=False,
    )
    rng = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (rng.randn(*x.shape) * 0.3).astype(np.float32), variables["params"]
    )
    bn = variables["batch_stats"]["output_unit"]["bn"]
    stats = {"output_unit": {"bn": {
        "mean": (rng.randn(*bn["mean"].shape) * 0.3).astype(np.float32),
        "var": (rng.rand(*bn["var"].shape) + 0.5).astype(np.float32),
    }}}
    return {"params": params, "batch_stats": stats}


@functools.lru_cache(maxsize=None)
def jax_case(unit_layers, graph_layers, nodes):
    """(variables, inputs, flax eval outputs as numpy), shared by the
    kernel-routing variants of one configuration."""
    model = JaxDualVGR(**dims(unit_layers, graph_layers, nodes))
    example = inputs(nodes)
    variables = random_variables(model, example)
    out = model.apply(variables, *example, train=False)
    return variables, example, {k: np.asarray(v) for k, v in out._asdict().items()}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("unit_layers,graph_layers,nodes", [
    (1, 1, 4), (2, 1, 8), (1, 2, 4), (2, 2, 8),
])
def test_eval_outputs_match_flax(unit_layers, graph_layers, nodes, use_kernels):
    variables, example, want = jax_case(unit_layers, graph_layers, nodes)
    model = build_model(device="cpu", use_kernels=use_kernels, **dims(unit_layers, graph_layers, nodes))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    app, mot, q, qlen = (torch.from_numpy(a) for a in example)
    got = model(app, mot, q, qlen)
    assert list(got._fields) == list(want)
    for field in got._fields:
        g = getattr(got, field).numpy()
        assert g.shape == want[field].shape, field
        np.testing.assert_allclose(g, want[field], atol=ATOL, err_msg=field)


def test_build_model_is_seeded_and_eval():
    kw = dims(1, 1, 4)
    a = build_model(device="cpu", seed=3, **kw)
    b = build_model(device="cpu", seed=3, **kw)
    c = build_model(device="cpu", seed=4, **kw)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert not a.training
    # reference init: zero biases, unit batch-norm scale, U(-1, 1) embedding
    assert torch.count_nonzero(sa["visual_input_unit.acGCN.0.attention_0.W.bias"]) == 0
    assert torch.equal(sa["output_unit.classifier.3.weight"], torch.ones(16))
    assert sa["linguistic_input_unit.encoder_embed.weight"].abs().max() <= 1.0
