"""Stacked-bank GAT execution (``DualVGR(batch_gats=True)``) in the port.

The three cases of ``tests/test_batched_gats.py``, held against the port's
per-module path and against the JAX package's ``batch_gats``: the eval
outputs at unit_layers x graph_layers (1, 1), (2, 1), (1, 2) (the port's
two paths within 2e-5, as the JAX test holds its own; against flax within
1e-4, as ``tests/test_torch_model.py``); the gradients of the same loss of
the eval outputs (against the per-module path and against JAX's batched
gradients within 1e-5 of the largest gradient of each top-level module:
about 1e-6 measured; a softmax bias's gradient is the residue of a sum
that cancels, so it is not held relative to itself); and training with
dropout on (one mask a
site for the four banks, replayed from the generator). The parameters are
the per-module path's, so one state_dict serves both. ``batch_gats`` is
ignored under GCN, and in eval with kernels on the graph-cycle kernel
still takes the cycle first, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import build_model, create_train_state, make_optimizer, train_step
from dualvgr_tpu_torch.models import dualvgr as tdualvgr
from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle_reference
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import dims, inputs, random_variables

FIELDS = ("logits", "aq_embed", "mq_embed", "com_app", "com_motion", "aq_fusion", "mq_fusion")


def case(unit_layers=1, graph_layers=1):
    kw = dims(unit_layers, graph_layers, 4)
    example = inputs(4)
    variables = random_variables(JaxDualVGR(**kw), example)
    return kw, variables, example


def port(kw, variables, **extra):
    model = build_model(device="cpu", use_kernels=False, **kw, **extra)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


@pytest.mark.parametrize("layers", [(1, 1), (2, 1), (1, 2)])
def test_batched_matches_per_module_forward(layers):
    kw, variables, example = case(*layers)
    args = [torch.from_numpy(a) for a in example]
    per_module = port(kw, variables)(*args)
    batched = port(kw, variables, batch_gats=True)(*args)
    want = JaxDualVGR(**kw, batch_gats=True).apply(variables, *example, train=False)
    for field in FIELDS:
        b = getattr(batched, field).numpy()
        np.testing.assert_allclose(b, getattr(per_module, field).numpy(), atol=2e-5, err_msg=field)
        np.testing.assert_allclose(b, np.asarray(getattr(want, field)), atol=1e-4, err_msg=field)


def _port_grads(model, args):
    """Gradients of the JAX test's loss of the eval-mode outputs."""
    model.zero_grad()
    with torch.enable_grad():
        out = model._forward(*args, None, None)
        loss = (out.logits ** 2).sum() + (out.com_app ** 2).sum() + (out.aq_fusion ** 2).sum()
        loss.backward()
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def test_batched_matches_per_module_gradients():
    kw, variables, example = case()
    args = [torch.from_numpy(a) for a in example]
    ga = _port_grads(port(kw, variables), args)
    gb = _port_grads(port(kw, variables, batch_gats=True), args)
    jmodel = JaxDualVGR(**kw, batch_gats=True)

    def loss(params):
        out = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, *example, train=False)
        return jnp.sum(out.logits ** 2) + jnp.sum(out.com_app ** 2) + jnp.sum(out.aq_fusion ** 2)

    want = from_jax_variables({"params": jax.grad(loss)(variables["params"]),
                               "batch_stats": variables["batch_stats"]})
    assert ga.keys() == gb.keys()
    # relative to the largest gradient of the top-level module: a softmax's
    # bias (shift-invariant) has a gradient that is a cancelling sum's residue
    scale = {}
    for k, g in ga.items():
        top = k.split(".")[0]
        scale[top] = max(scale.get(top, 1e-3), g.abs().max().item())
    errs = {}
    for k in ga:
        s = scale[k.split(".")[0]]
        errs[k] = (np.abs(gb[k].numpy() - ga[k].numpy()).max() / s, np.abs(gb[k].numpy() - want[k].numpy()).max() / s)
    for k, (e_port, e_jax) in errs.items():
        assert e_port <= 1e-5 and e_jax <= 1e-5, (k, e_port, e_jax)


def test_batched_trains_with_dropout():
    kw = dims(1, 1, 4)
    rng = np.random.RandomState(0)
    app, mot, q, qlen = inputs(4, b=6)
    data = (app, mot, q, qlen, rng.randint(0, kw["num_answers"], (6,)).astype(np.int32), np.ones(6, np.float32))
    runs = []
    for _ in range(2):
        model = build_model(device="cpu", seed=1, batch_gats=True, **kw)
        assert model.visual_input_unit.cycle_drop.p == model.visual_input_unit.acGCN[0].drop.p == 0.15
        before = {k: v.clone() for k, v in model.state_dict().items()}
        state = create_train_state(model, make_optimizer(1e-3, 10), seed=3)
        losses = [train_step(state, data, alpha=1.0, beta=1e-8)["loss"].item() for _ in range(2)]
        assert np.isfinite(losses).all()
        assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
        runs.append(losses)
    assert runs[0] == runs[1]  # the dropout masks replay from the generator
    # with dropout on, the batched and per-module paths draw other masks
    per_module = build_model(device="cpu", seed=1, **kw)
    state = create_train_state(per_module, make_optimizer(1e-3, 10), seed=3)
    assert train_step(state, data, alpha=1.0, beta=1e-8)["loss"].item() != runs[0][0]
    # and with dropout off they agree
    losses = []
    for extra in ({}, {"batch_gats": True}):
        model = build_model(device="cpu", seed=1, **kw, **extra)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        state = create_train_state(model, make_optimizer(1e-3, 10), seed=3)
        losses.append(train_step(state, data, alpha=1.0, beta=1e-8)["loss"].item())
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_batched_routing(monkeypatch):
    """Eval with kernels on: the graph-cycle kernel takes the cycle ahead of
    the stacked path (2 calls a forward); under GCN ``batch_gats`` changes
    nothing."""
    calls = []
    monkeypatch.setattr(tdualvgr, "gat_cycle", lambda *a: calls.append(1) or gat_cycle_reference(*a))
    kw, variables, example = case()
    args = [torch.from_numpy(a) for a in example]
    model = build_model(device="cpu", batch_gats=True, **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    fused = model(*args)
    assert len(calls) == 2
    model.use_kernels = False
    np.testing.assert_allclose(fused.logits.numpy(), model(*args).logits.numpy(), atol=1e-4)
    gcn = {**kw, "graph_module": "GCN"}
    a, b = build_model(device="cpu", **gcn)(*args), build_model(device="cpu", batch_gats=True, **gcn)(*args)
    assert len(calls) == 2
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)
