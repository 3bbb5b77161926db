"""The port's train step under ``compute_dtype="bfloat16"`` against JAX ``train_lib``.

* Two train steps from the same weights (the JAX package's init with every
  bias redrawn at 0.01, as tests/test_torch_train.py draws them), dropout
  off on both sides, then one more forward and backward: the losses of the
  steps and of the last forward, and the gradient norm of each top-level
  module after the two updates (compared there for the reason in PERF.md
  §6: at the zero-bias init QueryAttn normalizes exactly-zero vectors),
  for each routing against its JAX routing: ``use_kernels=False`` against
  ``use_pallas=False``, ``use_kernels=True`` (on the CPU, the plain
  versions of kernel 6 without tanh and of kernels 3 and 4 with bf16 gates
  in the appearance op; fp32 gates through ``stream_roundtrip`` in the
  question encoders) against ``use_pallas=True`` with its Pallas kernels in
  interpret mode (``jax_kernels_interpreted``, as the JAX package's own
  tests run them).
  Tolerances: the loss within 1e-6 relative, each module's gradient norm
  within 1e-5 relative (measured: 1e-7 and 8e-7). The JAX package's own
  bf16-vs-fp32 gap (its fp32 XLA routing, which its fp32 kernel routing
  matches to 2e-6) is asserted to be at least 10x each tolerance, module
  by module. The seed is one where no bf16 rounding flips between the two
  frameworks: at seeds 4 and 5 a dgate or an activation lands on the other
  side of a bf16 rounding boundary in one framework, and the norms of the
  question encoders and of ContextSelfAttn (whose gradient is 1e-4 in
  norm) then move by 2e-4 to 2e-3 relative, in either routing.
* ``appearance_bilstm_train(stream_dtype=bf16)`` against the JAX
  ``appearance_bilstm_train(stream_dtype="bfloat16")``, its kernels in
  interpret mode:
  the final states and the gradients of W_ih, the bias and W_hh, atol 1e-5
  (measured 5e-7), each at least 10x below the JAX bf16-vs-fp32 gap.
"""

import contextlib
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dualvgr_tpu.ops.lstm_pallas_train as lpt
from dualvgr_tpu import train_lib as jtrain
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import train_lib
from dualvgr_tpu_torch.ops import lstm_train
from dualvgr_tpu_torch.ops.proj_kernel import input_proj_both
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import dims
from test_torch_model_bf16 import jax_kernels_interpreted
from test_torch_train import ALPHA, BETA, LR, batch, jax_state, port_model, train_variables

SEED = 3
RTOL_LOSS, RTOL_GNORM = 1e-6, 1e-5
ATOL_APP = 1e-5


def module_norms(named_grads):
    """The gradient norm of each top-level module, from {state_dict key: gradient}."""
    sq = {}
    for k, g in named_grads.items():
        top = k.split(".")[0]
        sq[top] = sq.get(top, 0.0) + float((np.asarray(g, np.float64) ** 2).sum())
    return {k: v ** 0.5 for k, v in sq.items()}


def _jax_loss_and_grads(jmodel, jstate, data):
    """The loss and the gradients JAX ``train_step`` would apply (its loss_fn)."""
    from dualvgr_tpu.ops.losses import dualvgr_total_loss

    app, mot, q, qlen, answers, valid = data

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": jstate.batch_stats}, app, mot, q, qlen,
                              valid, train=True, mutable=["batch_stats"])
        total, _ = dualvgr_total_loss(out.logits, answers, out.aq_fusion, out.com_app, out.mq_fusion,
                                      out.com_motion, alpha=ALPHA, beta=BETA,
                                      num_of_nodes=jmodel.num_of_nodes, valid=valid)
        return total

    return jax.value_and_grad(loss_fn)(jstate.params)


@functools.lru_cache(maxsize=None)
def jax_run(compute_dtype, use_pallas):
    """JAX: the losses of two train steps, then the loss and module gradient
    norms of one more forward and backward, dropout off."""
    orig = flax.linen.Dropout.__call__
    flax.linen.Dropout.__call__ = lambda self, x, *a, **k: x
    try:
        kw = dims(1, 1, 4)
        data = batch(4, seed=SEED)
        variables = train_variables(JaxDualVGR(**kw), data, seed=SEED)
        model = JaxDualVGR(**kw, compute_dtype=compute_dtype, use_pallas=use_pallas)
        opt = jtrain.make_optimizer(LR, 10)
        state = jax_state(model, variables, opt)
        losses = []
        with jax_kernels_interpreted() if use_pallas else contextlib.nullcontext():
            for _ in range(2):
                state, metrics = jtrain.train_step(state, data, model=model, optimizer=opt, alpha=ALPHA, beta=BETA)
                losses.append(float(metrics["loss"]))
            loss, grads = _jax_loss_and_grads(model, state, data)
        losses.append(float(loss))
        named = from_jax_variables({"params": grads, "batch_stats": state.batch_stats})
        return variables, losses, named
    finally:
        flax.linen.Dropout.__call__ = orig


@pytest.mark.parametrize("use_kernels", [True, False])
def test_bf16_train_step_matches_its_jax_routing(use_kernels):
    variables, want_losses, want_named = jax_run("bfloat16", use_kernels)
    _, fp32_losses, fp32_named = jax_run("float32", False)
    kw = dims(1, 1, 4)
    data = batch(4, seed=SEED)
    model = port_model(variables, kw, use_kernels=use_kernels)
    model.compute_dtype = "bfloat16"
    state = train_lib.create_train_state(model, train_lib.make_optimizer(LR, 10), seed=0)
    losses = [train_lib.train_step(state, data, alpha=ALPHA, beta=BETA)["loss"].item() for _ in range(2)]
    losses.append(train_lib.forward_backward(state, data, alpha=ALPHA, beta=BETA)["loss"].item())
    for got, want, f32 in zip(losses, want_losses, fp32_losses):
        assert abs(got - want) <= RTOL_LOSS * abs(want), (got, want)
        assert abs(want - f32) >= 10 * RTOL_LOSS * abs(want), (want, f32)

    grads = {k: p.grad for k, p in model.named_parameters()}
    got = module_norms(grads)
    want = module_norms({k: v for k, v in want_named.items() if k in grads})
    f32 = module_norms({k: v for k, v in fp32_named.items() if k in grads})
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert abs(got[name] - w) <= RTOL_GNORM * w, (name, got[name], w)
        assert abs(w - f32[name]) >= 10 * RTOL_GNORM * w, (name, w, f32[name])


def test_appearance_op_bf16_matches_pallas_interpret(rng):
    r, t, d, h = 8, 5, 32, 8
    x = np.tanh(rng.randn(r, t, d)).astype(np.float32)
    w = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in (
        ("wih_f", (4 * h, d)), ("b_f", (4 * h,)), ("whh_f", (4 * h, h)),
        ("wih_b", (4 * h, d)), ("b_b", (4 * h,)), ("whh_b", (4 * h, h)))}
    tgt = rng.randn(r, 2 * h).astype(np.float32)
    order = ("wih_f", "b_f", "whh_f", "wih_b", "b_b", "whh_b")

    def jrun(sd):
        def jloss(args):
            wif, bf, whf, wib, bb, whb = args
            f = lpt.appearance_bilstm_train(jnp.asarray(x), wif.T, bf, whf.T, wib.T, bb, whb.T, block_r=r,
                                            stream_dtype=sd)
            return ((f - tgt) ** 2).sum(), f

        with jax_kernels_interpreted():
            (_, final), grads = jax.value_and_grad(jloss, has_aux=True)(tuple(jnp.asarray(w[k]) for k in order))
        return np.asarray(final), [np.asarray(g) for g in grads]

    want_final, want = jrun("bfloat16")
    f32_final, f32 = jrun(None)

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    n0 = input_proj_both.launches
    final = lstm_train.appearance_bilstm_train(
        torch.from_numpy(x), leaves["wih_f"], leaves["b_f"], leaves["whh_f"].t().contiguous(),
        leaves["wih_b"], leaves["b_b"], leaves["whh_b"].t().contiguous(), stream_dtype=torch.bfloat16,
    )
    ((final - torch.from_numpy(tgt)) ** 2).sum().backward()
    assert input_proj_both.launches == n0  # CPU: kernel 6's plain version
    np.testing.assert_allclose(final.detach().numpy(), want_final, atol=ATOL_APP)
    assert np.abs(want_final - f32_final).max() >= 10 * ATOL_APP
    for k, g, g32 in zip(order, want, f32):
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, atol=ATOL_APP, err_msg=k)
        assert np.abs(g - g32).max() >= 10 * ATOL_APP, k
