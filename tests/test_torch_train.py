"""The port's train step against the JAX package's ``train_lib``.

Same randomized weights (every leaf drawn from numpy), the same numpy batch
with the last 2 of 6 rows padded (``valid`` = 0), dropout off on both sides:
on the JAX side ``flax.linen.Dropout.__call__`` is patched to the identity
for the test (nothing in ``dualvgr_tpu`` changes), on the port's side every
dropout site is set to p = 0. Checked:

* the train-mode forward: logits, the six auxiliary outputs and the
  updated batch-norm running statistics, unit_layers 1/2 x graph_layers
  1/2, with the trainable kernel routing on and off (on the CPU the
  kernels' plain versions run);
* two train steps against JAX ``train_step`` with the same
  ``make_optimizer``: the loss (rtol 2e-4, as tests/test_training_parity.py),
  every gradient of the first step mapped through ``from_jax_variables``
  (a pure re-layout; normalized atol 5e-5, 5e-4 for QueryAttn, whose
  l2-normalize and masked softmax amplify fp32 reorder noise, as
  tests/test_pallas_train.py, and for the GAT attention biases, below),
  the parameters after both steps (atol 5e-5);
* a clipping case, the lr schedule, grad_accum = 2 against optax.MultiSteps,
  ``set_glove``, and the dropout generator.

The steps start from the JAX package's own init (``create_train_state``),
where the gradients are well conditioned, with every bias redrawn at 0.01
so that no exactly-zero vector reaches an l2-normalize (at a zero bias the
padded question positions do, and QueryAttn's gradient is then fp32 noise
times 1e12 in both frameworks). At random weights of scale 0.3 a punished
GAT can emit nodes that are equal to fp32 precision, and the common loss's
normalize then turns rounding noise into O(1) gradients: such points test
nothing about the port. The GAT attention biases (``a.bias``) take the
QueryAttn tolerance too: a softmax is invariant to a shift of its logits,
so their gradient is the small residue the LeakyReLU leaves of a sum that
cancels, and its fp32 rounding in either framework is of the order of
the tight tolerance.
"""

import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvgr_tpu import train_lib as jtrain
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import build_model, train_lib
from dualvgr_tpu_torch.config import cfg_from_file
from dualvgr_tpu_torch.ops.dropout import Dropout, dropout
from dualvgr_tpu_torch.ops.lstm_train_kernel import bilstm_train_bwd, bilstm_train_fwd
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import ANSWERS, T, VISION, VOCAB, dims, random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI's loss weights (train.py) and the shipped configs' learning rate
ALPHA, BETA = 1.0, 1e-8
LR = cfg_from_file(os.path.join(ROOT, "configs", "msrvtt_qa_DualVGR_16.yml")).train.lr
B, PAD, FRAMES = 6, 2, 3
ATOL_OUT = 1e-4
ATOL_GRAD, ATOL_GRAD_AMPLIFIED = 5e-5, 5e-4
ATOL_PARAM = 5e-5


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)


def batch(nodes, seed=0):
    """(app, motion, question, qlen, answers, valid) as numpy, 2 padded rows."""
    rng = np.random.RandomState(seed)
    app = rng.randn(B, nodes, FRAMES, VISION).astype(np.float32)
    mot = rng.randn(B, nodes, VISION).astype(np.float32)
    qlen = rng.randint(1, T + 1, (B,)).astype(np.int32)
    qlen[0] = 1
    q = rng.randint(1, VOCAB, (B, T)).astype(np.int32)
    for i in range(B):
        q[i, qlen[i]:] = 0
    answers = rng.randint(0, ANSWERS, (B,)).astype(np.int32)
    valid = np.ones(B, np.float32)
    valid[-PAD:] = 0.0
    return app, mot, q, qlen, answers, valid


def port_model(variables, kw, *, use_kernels=True, p=0.0):
    model = build_model(device="cpu", use_kernels=use_kernels, **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = p
    return model


def train_variables(jmodel, data, seed):
    """The JAX package's init with every bias (every 1-d leaf) redrawn at 0.01."""
    init = jtrain.create_train_state(jmodel, jax.random.PRNGKey(seed), data[:4],
                                     jtrain.make_optimizer(LR, 10))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if np.ndim(x) > 1 else (rng.randn(*np.shape(x)) * 0.01).astype(np.float32),
        init.params,
    )
    return {"params": params, "batch_stats": init.batch_stats}


def jax_state(model, variables, optimizer):
    return jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"], opt_state=optimizer.init(variables["params"]),
        rng=jax.random.PRNGKey(0),
    )


def port_params(model):
    return {k: v.detach() for k, v in model.named_parameters()}


def assert_params_match(model, jstate, atol=ATOL_PARAM):
    want = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), atol=atol, err_msg=k)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_train_forward_matches_flax(no_jax_dropout, unit_layers, graph_layers, use_kernels):
    kw = dims(unit_layers, graph_layers, 4)
    jmodel = JaxDualVGR(**kw)
    data = batch(4)
    variables = random_variables(jmodel, data[:4])
    want, mutated = jmodel.apply(variables, *data[:4], data[5], train=True, mutable=["batch_stats"])

    model = port_model(variables, kw, use_kernels=use_kernels)
    model.train()
    app, mot, q, qlen, _, valid = (torch.from_numpy(a) for a in data)
    got = model(app, mot, q, qlen, valid, generator=torch.Generator().manual_seed(0))
    for field in got._fields:
        g = getattr(got, field)
        assert g.requires_grad, field
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(getattr(want, field)), atol=ATOL_OUT,
                                   err_msg=field)
    bn = model.output_unit.classifier[3]
    stats = mutated["batch_stats"]["output_unit"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=ATOL_OUT)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=ATOL_OUT)
    assert int(bn.num_batches_tracked) == 1


def _jax_grads(jmodel, jstate, data):
    """The gradients JAX train_step applies (its loss_fn, dropout patched out)."""
    from dualvgr_tpu.ops.losses import dualvgr_total_loss

    app, mot, q, qlen, answers, valid = data

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats}, app, mot, q, qlen,
                              valid, train=True, mutable=["batch_stats"])
        total, _ = dualvgr_total_loss(out.logits, answers, out.aq_fusion, out.com_app, out.mq_fusion,
                                      out.com_motion, alpha=ALPHA, beta=BETA,
                                      num_of_nodes=jmodel.num_of_nodes, valid=valid)
        return total

    return jax.grad(loss_fn)(jstate.params)


def test_two_train_steps_match_jax(no_jax_dropout):
    assert LR == 1e-4
    kw = dims(1, 1, 4)
    jmodel = JaxDualVGR(**kw)
    data = batch(4, seed=2)
    variables = train_variables(jmodel, data, seed=2)
    jopt = jtrain.make_optimizer(LR, 10)
    jstate = jax_state(jmodel, variables, jopt)

    model = port_model(variables, kw)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10), seed=0)
    n0 = (bilstm_train_fwd.launches, bilstm_train_bwd.launches)

    # step 1, gradients first
    metrics = train_lib.forward_backward(state, data, alpha=ALPHA, beta=BETA)
    want = from_jax_variables({"params": _jax_grads(jmodel, jstate, data),
                               "batch_stats": jstate.batch_stats})
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(grads) == sorted(k for k in want if k in grads) and len(grads) == len(want) - 3
    for k, g in grads.items():
        w = want[k].numpy()
        scale = max(np.abs(w).max(), 1e-3)
        atol = ATOL_GRAD_AMPLIFIED if ".queryAttn." in k or k.endswith(".a.bias") else ATOL_GRAD
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=atol, err_msg=k)
    train_lib.apply_gradients(state)
    jstate, jmetrics = jtrain.train_step(jstate, data, model=jmodel, optimizer=jopt, alpha=ALPHA, beta=BETA)
    for k in ("loss", "ce", "common", "dependence"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=2e-4, err_msg=k)
    assert metrics["count"].item() == B - PAD == int(jmetrics["count"])
    assert metrics["correct"].item() == float(jmetrics["correct"])

    # step 2
    metrics = train_lib.train_step(state, data, alpha=ALPHA, beta=BETA)
    jstate, jmetrics = jtrain.train_step(jstate, data, model=jmodel, optimizer=jopt, alpha=ALPHA, beta=BETA)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=2e-4)
    assert (state.step, state.updates) == (2, 2)
    assert_params_match(model, jstate)
    # CPU tensors: the trainable pair ran as plain PyTorch, no kernel launched
    assert (bilstm_train_fwd.launches, bilstm_train_bwd.launches) == n0


def test_clipping_matches_optax(no_jax_dropout):
    kw = dims(1, 1, 4)
    jmodel = JaxDualVGR(**kw)
    data = batch(4, seed=1)
    variables = train_variables(jmodel, data, seed=1)
    max_norm = 0.05
    jopt = jtrain.make_optimizer(LR, 10, max_grad_norm=max_norm)
    jstate = jax_state(jmodel, variables, jopt)
    model = port_model(variables, kw)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10, max_grad_norm=max_norm))
    for _ in range(2):
        train_lib.forward_backward(state, data, alpha=ALPHA, beta=BETA)
        raw = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
        assert raw > max_norm  # the clip fires
        train_lib.apply_gradients(state)
        # the applied gradient has the clip's norm exactly
        clipped = torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()]))
        np.testing.assert_allclose(clipped.item(), max_norm, rtol=1e-5)
        jstate, _ = jtrain.train_step(jstate, data, model=jmodel, optimizer=jopt, alpha=ALPHA, beta=BETA)
    assert_params_match(model, jstate)


def test_lr_schedule_halves_every_ten_epochs():
    sched = train_lib.make_lr_schedule(1e-4, 100)
    jsched = jtrain.make_lr_schedule(1e-4, 100)
    for step, lr in ((0, 1e-4), (999, 1e-4), (1000, 5e-5), (1999, 5e-5), (2000, 2.5e-5)):
        assert sched(step) == pytest.approx(lr) == pytest.approx(float(jsched(step)))
    # under accumulation the schedule reads micro-steps: 250 updates of 4 = epoch 10
    opt = train_lib.make_optimizer(1e-4, 100, grad_accum=4)
    assert opt.lr(249) == pytest.approx(1e-4) and opt.lr(250) == pytest.approx(5e-5)
    with pytest.raises(ValueError):
        train_lib.make_optimizer(1e-4, 100, grad_accum=0)


def test_update_takes_the_lr_at_the_count_of_applied_updates():
    model = build_model(device="cpu", **dims(1, 1, 4))
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 1))
    data = batch(4)
    state.updates = 10  # epoch 10 of 1 step each
    train_lib.train_step(state, data, alpha=ALPHA, beta=BETA)
    assert state.adam.param_groups[0]["lr"] == pytest.approx(5e-4)
    assert state.updates == 11


def test_grad_accum_matches_optax_multisteps(no_jax_dropout):
    kw = dims(1, 1, 4)
    jmodel = JaxDualVGR(**kw)
    batches = [batch(4, seed=3), batch(4, seed=4)]
    variables = train_variables(jmodel, batches[0], seed=3)
    jopt = jtrain.make_optimizer(LR, 10, grad_accum=2)
    jstate = jax_state(jmodel, variables, jopt)
    model = port_model(variables, kw)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10, grad_accum=2))
    before = {k: v.clone() for k, v in port_params(model).items()}
    for i, data in enumerate(batches * 2):
        metrics = train_lib.train_step(state, data, alpha=ALPHA, beta=BETA)
        jstate, jmetrics = jtrain.train_step(jstate, data, model=jmodel, optimizer=jopt, alpha=ALPHA,
                                             beta=BETA)
        np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=2e-4)
        if i == 0:  # the first micro-step only accumulates
            assert state.updates == 0 and state.mini_step == 1
            assert all(torch.equal(before[k], v) for k, v in port_params(model).items())
    assert (state.step, state.updates, state.mini_step) == (4, 2, 0)
    assert_params_match(model, jstate)
    train_lib.train_step(state, batches[0], alpha=ALPHA, beta=BETA)
    assert state.mini_step == 1 and any(a.abs().sum() > 0 for a in state.acc_grads)
    train_lib.reset_grad_accum(state)
    assert state.mini_step == 0 and all(a.abs().sum() == 0 for a in state.acc_grads)


def test_set_glove():
    model = build_model(device="cpu", **dims(1, 1, 4))
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10))
    glove = np.random.RandomState(0).randn(VOCAB, 10).astype(np.float32)
    train_lib.set_glove(state, glove)
    np.testing.assert_array_equal(model.linguistic_input_unit.encoder_embed.weight.detach().numpy(), glove)
    with pytest.raises(ValueError, match="GloVe"):
        train_lib.set_glove(state, glove[:, :5])


def test_dropout_generator_replays_a_step_and_keeps_its_rate():
    kw = dims(1, 1, 4)
    data = batch(4)
    runs = []
    for _ in range(2):
        model = build_model(device="cpu", seed=1, **kw)
        state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10), seed=7)
        metrics = train_lib.train_step(state, data, alpha=ALPHA, beta=BETA)
        runs.append((metrics["loss"].item(), port_params(model)))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    # a training forward without a generator is refused
    with pytest.raises(ValueError, match="Generator"):
        model(*(torch.from_numpy(a) for a in data[:4]))

    n, p = 10**5, 0.15
    y = dropout(torch.ones(n), p, generator=torch.Generator().manual_seed(0), training=True)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n)
    np.testing.assert_allclose(y[y != 0].numpy(), 1 / (1 - p), rtol=1e-6)
    assert dropout(torch.ones(3), p, generator=None, training=False).eq(1).all()


def test_gradient_norms_are_stable_after_two_updates():
    """The condition ``chip_smoke.py``'s train agreement relies on: after two
    updates (biases off zero), a change of the input by one part in a
    million moves no top-level module's gradient norm by more than 1e-5
    relative, so a 1e-3 check between the kernel and plain paths measures
    the kernels, not the model's conditioning."""
    model = build_model(device="cpu", **dims(1, 1, 4))
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10), seed=0)
    data = batch(4, seed=5)
    for _ in range(2):
        train_lib.train_step(state, data, alpha=ALPHA, beta=BETA)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    noise = np.random.RandomState(6).randn(*data[0].shape).astype(np.float32)

    def norms(app):
        train_lib.forward_backward(state, (app, *data[1:]), alpha=ALPHA, beta=BETA)
        return {name: torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in mod.parameters()])).item()
                for name, mod in model.named_children()}

    base, moved = norms(data[0]), norms(data[0] * (1 + 1e-6 * noise))
    for name, v in base.items():
        assert abs(moved[name] - v) <= 1e-5 * v, name
