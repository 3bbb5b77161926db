"""The port's GCN graph module (``graph_module: GCN``, the config default)
against the JAX package's, on the CPU.

* ``PunishGCN`` against flax's, with and without the punishment scores;
  its weight is the reference's (in, out) matrix, carried untransposed;
* the GCN DualVGR's eval outputs (logits and the six auxiliary outputs)
  against flax at unit_layers x graph_layers in {1, 2}^2, kernel routing
  on and off (atol 1e-4 as ``tests/test_torch_model.py``), and under
  ``compute_dtype: bfloat16`` against the JAX package's own routing of
  each (atol 2e-5 as ``tests/test_torch_model_bf16.py``; the GCN product
  stays fp32 in both);
* the train-mode forward against flax's (dropout off on both sides) and
  one train step: the loss, every gradient and the parameters after the
  update against JAX ``train_step`` (the tolerances of
  ``tests/test_torch_train.py``);
* a GCN checkpoint round trip bit for bit, the init, the routing (no
  graph-cycle kernel for GCN), ``kernel_dim_limits`` and an unknown module.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

from dualvgr_tpu import train_lib as jtrain
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.models.graph import PunishGCN as JaxPunishGCN
from dualvgr_tpu.models.graph import dense_self_loop_adjacency
from dualvgr_tpu_torch import build_model, create_train_state, make_optimizer, train_lib, train_step
from dualvgr_tpu_torch.models import dualvgr as tdualvgr
from dualvgr_tpu_torch.models.dualvgr import DualVGR, kernel_dim_limits
from dualvgr_tpu_torch.models.graph import GraphConvolution, PunishGCN
from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle_reference
from dualvgr_tpu_torch.utils import port_reference
from dualvgr_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from dualvgr_tpu_torch.utils.weights import from_jax_variables, load_flax_params

from test_torch_model import dims, inputs, random_variables
from test_torch_model_bf16 import jax_kernels_interpreted
from test_torch_train import (
    ALPHA, ATOL_GRAD, ATOL_GRAD_AMPLIFIED, B, BETA, LR, PAD, _jax_grads, assert_params_match, batch, jax_state,
    no_jax_dropout, port_model, train_variables,
)

ATOL = 1e-4
ATOL_BF16 = 2e-5
GCN = dict(graph_module="GCN")


@functools.lru_cache(maxsize=None)
def jax_case(unit_layers, graph_layers, nodes=4):
    """(variables, inputs, {(compute_dtype, use_pallas): flax eval outputs})
    of a GCN DualVGR; the fp32 XLA routing always, the others on demand."""
    kw = dims(unit_layers, graph_layers, nodes)
    example = inputs(nodes)
    variables = random_variables(JaxDualVGR(**kw, **GCN), example)
    return variables, example, {}


def jax_outputs(unit_layers, graph_layers, compute_dtype="float32", use_pallas=False):
    variables, example, outs = jax_case(unit_layers, graph_layers)
    key = (compute_dtype, use_pallas)
    if key not in outs:
        model = JaxDualVGR(**dims(unit_layers, graph_layers, 4), **GCN, compute_dtype=compute_dtype,
                           use_pallas=use_pallas)
        with jax_kernels_interpreted() if use_pallas else contextlib.nullcontext():
            out = model.apply(variables, *example, train=False)
        outs[key] = {k: np.asarray(v) for k, v in out._asdict().items()}
    return variables, example, outs[key]


def port_gcn(variables, unit_layers, graph_layers, **kw):
    model = build_model(device="cpu", **dims(unit_layers, graph_layers, 4), **GCN, **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


@pytest.mark.parametrize("with_scores", [True, False])
def test_punish_gcn_matches_flax(with_scores):
    rng = np.random.RandomState(0)
    b, n, d = 3, 5, 16
    h = rng.randn(b, n, d).astype(np.float32)
    scores = np.repeat(rng.rand(b, n, 1), d // 4, axis=2).astype(np.float32) if with_scores else None
    adj = np.asarray(dense_self_loop_adjacency(n))
    jm = JaxPunishGCN(d)
    variables = jm.init(jax.random.PRNGKey(0), h, adj, scores, train=False)
    want = np.asarray(jm.apply(variables, h, adj, scores, train=False))
    m = PunishGCN(d).eval()
    sd = load_flax_params(m, variables["params"])
    # the reference's (in, out) weight crosses untransposed
    np.testing.assert_array_equal(sd["gc1.weight"].numpy(), np.asarray(variables["params"]["gc1"]["weight"]))
    m.load_state_dict(sd, strict=True)
    got = m(torch.from_numpy(h), torch.from_numpy(adj), None if scores is None else torch.from_numpy(scores))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    assert (want >= 0).all()  # relu


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_gcn_eval_outputs_match_flax(unit_layers, graph_layers, use_kernels):
    variables, example, want = jax_outputs(unit_layers, graph_layers)
    model = port_gcn(variables, unit_layers, graph_layers, use_kernels=use_kernels)
    got = model(*(torch.from_numpy(a) for a in example))
    assert list(got._fields) == list(want)
    for field in got._fields:
        g = getattr(got, field).numpy()
        assert g.shape == want[field].shape, field
        np.testing.assert_allclose(g, want[field], atol=ATOL, err_msg=field)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (1, 2)])
def test_gcn_bf16_eval_matches_its_jax_routing(unit_layers, graph_layers, use_kernels):
    variables, example, want = jax_outputs(unit_layers, graph_layers, "bfloat16", use_kernels)
    _, _, fp32 = jax_outputs(unit_layers, graph_layers, "float32", use_kernels)
    model = port_gcn(variables, unit_layers, graph_layers, use_kernels=use_kernels, compute_dtype="bfloat16")
    got = model(*(torch.from_numpy(a) for a in example))
    for field in got._fields:
        g = getattr(got, field)
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), want[field], atol=ATOL_BF16, err_msg=field)
        assert np.abs(want[field] - fp32[field]).max() >= 10 * ATOL_BF16, field


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 2)])
def test_gcn_train_forward_matches_flax(no_jax_dropout, unit_layers, graph_layers, use_kernels):
    kw = dims(unit_layers, graph_layers, 4)
    jmodel = JaxDualVGR(**kw, **GCN)
    data = batch(4)
    variables = random_variables(jmodel, data[:4])
    want, mutated = jmodel.apply(variables, *data[:4], data[5], train=True, mutable=["batch_stats"])
    model = port_model(variables, {**kw, **GCN}, use_kernels=use_kernels)
    model.train()
    app, mot, q, qlen, _, valid = (torch.from_numpy(a) for a in data)
    got = model(app, mot, q, qlen, valid, generator=torch.Generator().manual_seed(0))
    for field in got._fields:
        g = getattr(got, field)
        assert g.requires_grad, field
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(getattr(want, field)), atol=ATOL, err_msg=field)
    stats = mutated["batch_stats"]["output_unit"]["bn"]
    np.testing.assert_allclose(model.output_unit.classifier[3].running_var.numpy(), np.asarray(stats["var"]),
                               atol=ATOL)


def test_gcn_train_step_matches_jax(no_jax_dropout):
    kw = {**dims(1, 1, 4), **GCN}
    jmodel = JaxDualVGR(**kw)
    data = batch(4, seed=2)
    variables = train_variables(jmodel, data, seed=2)
    jopt = jtrain.make_optimizer(LR, 10)
    jstate = jax_state(jmodel, variables, jopt)
    model = port_model(variables, kw)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10), seed=0)

    metrics = train_lib.forward_backward(state, data, alpha=ALPHA, beta=BETA)
    want = from_jax_variables({"params": _jax_grads(jmodel, jstate, data), "batch_stats": jstate.batch_stats})
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert any(".gc1.weight" in k for k in grads) and len(grads) == len(want) - 3
    for k, g in grads.items():
        w = want[k].numpy()
        scale = max(np.abs(w).max(), 1e-3)
        atol = ATOL_GRAD_AMPLIFIED if ".queryAttn." in k else ATOL_GRAD
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=atol, err_msg=k)
    train_lib.apply_gradients(state)
    jstate, jmetrics = jtrain.train_step(jstate, data, model=jmodel, optimizer=jopt, alpha=ALPHA, beta=BETA)
    for k in ("loss", "ce", "common", "dependence"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)
    assert metrics["count"].item() == B - PAD
    assert_params_match(model, jstate)


def test_gcn_checkpoint_round_trip_is_bit_exact(tmp_path):
    kw = {**dims(2, 1, 4), **GCN}
    data = batch(4)
    state = create_train_state(build_model(device="cpu", seed=1, **kw), make_optimizer(1e-3, 4), seed=1)
    for _ in range(2):
        train_step(state, data, alpha=ALPHA, beta=BETA)
    save_checkpoint(str(tmp_path), 1, state, {"graph_module": "GCN"})
    twin = create_train_state(build_model(device="cpu", seed=5, **kw), make_optimizer(1e-3, 4), seed=5)
    epoch, twin = restore_checkpoint(str(tmp_path), twin)
    assert epoch == 1
    sa, sb = state.model.state_dict(), twin.model.state_dict()
    assert sa.keys() == sb.keys() and "visual_input_unit.acGCN.1.gc1.weight" in sa
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not any(".attention_0." in k for k in sa)
    oa, ob = state.adam.state_dict()["state"], twin.adam.state_dict()["state"]
    assert all(torch.equal(oa[i][k], ob[i][k]) for i in oa for k in oa[i])
    assert torch.equal(state.generator.get_state(), twin.generator.get_state())
    a, b = (train_step(s, data, alpha=ALPHA, beta=BETA)["loss"] for s in (state, twin))
    assert torch.equal(a, b)


def test_gcn_init_routing_and_limits(monkeypatch):
    model = build_model(device="cpu", seed=0, **dims(1, 1, 4), **GCN)
    w = model.visual_input_unit.acGCN[0].gc1.weight
    assert isinstance(model.visual_input_unit.acGCN[0].gc1, GraphConvolution) and w.shape == (16, 16)
    # the reference's uniform(-1/sqrt(out), 1/sqrt(out)), not xavier's wider sqrt(6/32) bound
    assert w.abs().max() <= 0.25 and w.abs().max() > 0.2
    # GCN never reaches the graph-cycle kernel, GAT twice a forward
    calls = []
    monkeypatch.setattr(tdualvgr, "gat_cycle", lambda *a: calls.append(1) or gat_cycle_reference(*a))
    example = [torch.from_numpy(a) for a in inputs(4)]
    model(*example)
    assert calls == []
    build_model(device="cpu", **dims(1, 1, 4))(*example)
    assert len(calls) == 2
    # the graph-cycle limits bind GAT with graph_layers 1 only
    assert kernel_dim_limits(num_of_nodes=32, graph_module="GCN") == []
    assert kernel_dim_limits(num_of_nodes=32, module_dim=16, graph_module="GCN", compute_dtype="bfloat16") == []
    assert any("num_of_nodes" in m for m in kernel_dim_limits(num_of_nodes=32, graph_module="GAT"))
    assert kernel_dim_limits(num_of_nodes=32, graph_module="GAT", graph_layers=2) == []
    assert any("hidden" in m for m in kernel_dim_limits(module_dim=1024, graph_module="GCN"))


def test_unknown_graph_module_raises():
    for make in (lambda: build_model(device="cpu", graph_module="BOGUS", **dims(1, 1, 4)),
                 lambda: DualVGR(graph_module="GCN2", **dims(1, 1, 4))):
        with pytest.raises(ValueError, match="unknown graph_module"):
            make()
    # a reference .pt holds GAT banks only: the converter says so for GCN
    with pytest.raises(ValueError, match="GAT banks only"):
        port_reference.checked_model({}, {"graph_module": "GCN"}, "cpu")
