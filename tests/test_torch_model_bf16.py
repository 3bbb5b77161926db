"""The port's eval forward under ``compute_dtype="bfloat16"`` against the JAX package's.

Under bf16 streaming the JAX package's two routings give different numbers
by design: its kernel routing (``use_pallas=True``) reads bf16 gates into
the recurrence kernel and gets bf16 final states and outputs back, and its
fused graph cycle stays fp32, while its XLA routing keeps the recurrence
in fp32 and streams the plain GAT modules (about 1e-2 apart in the logits
here). So each routing of the port is held against its own JAX routing, on
the same randomized weights and numpy inputs: ``use_kernels=False`` against
flax with ``use_pallas=False``, ``use_kernels=True`` (the kernels' plain
versions on the CPU: kernel 6's with tanh fused, kernel 1's with bf16
gates) against flax with ``use_pallas=True`` with its Pallas kernels in
interpret mode as the JAX package's own tests run them
(``jax_kernels_interpreted``), at unit_layers x graph_layers in
{(1, 1), (2, 1), (1, 2)}, all seven outputs.

Tolerance: atol 2e-5. The two sides round the same fp32 values to bf16 at
the same places, so they differ by the order of the fp32 sums (up to 7e-7
measured here); a sum that lands on the other side of a bf16 rounding
boundary would move a value by one bf16 ulp and show as a larger error,
and none does at these seeds. Each test also asserts that the JAX package's
own bf16-vs-fp32 gap on the same inputs is at least 10x the tolerance in
every output, so the test tells the bf16 path from the fp32 one.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualvgr_tpu.ops.gat_pallas as gp
import dualvgr_tpu.ops.lstm_pallas as lp
import dualvgr_tpu.ops.lstm_pallas_train as lpt
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import dims, inputs, random_variables

ATOL = 2e-5
NODES = 4


@contextlib.contextmanager
def jax_kernels_interpreted():
    """The JAX package's Pallas kernels in interpret mode on the CPU, the way
    its own tests run them: kernels 1 and 2 through ``interpret=True``
    partials (tests/test_pallas.py), the trainable pair through
    ``lstm_pallas_train.INTERPRET`` (tests/test_pallas_train.py); all
    restored on exit. (The TPU interpret mode,
    ``pltpu.force_tpu_interpret_mode()``, simulates the chip with callbacks
    and locks and can stall a test worker: every thread asleep on a futex.)"""
    orig = lp.bilstm_pallas, gp.fused_gat_cycle, lpt.INTERPRET
    lp.bilstm_pallas = functools.partial(orig[0], interpret=True)
    gp.fused_gat_cycle = functools.partial(orig[1], interpret=True)
    lpt.INTERPRET = True
    try:
        yield
    finally:
        lp.bilstm_pallas, gp.fused_gat_cycle, lpt.INTERPRET = orig


def _apply(kw, variables, example, compute_dtype, use_pallas):
    model = JaxDualVGR(**kw, compute_dtype=compute_dtype, use_pallas=use_pallas)
    with jax_kernels_interpreted() if use_pallas else contextlib.nullcontext():
        out = model.apply(variables, *example, train=False)
    return {k: np.asarray(v) for k, v in out._asdict().items()}


@functools.lru_cache(maxsize=None)
def jax_case(unit_layers, graph_layers):
    """(variables, inputs, {(compute_dtype, use_pallas): flax outputs}), one
    init shared by both routings and both dtypes."""
    kw = dims(unit_layers, graph_layers, NODES)
    example = inputs(NODES)
    variables = random_variables(JaxDualVGR(**kw), example)
    outs = {(cd, pal): _apply(kw, variables, example, cd, pal)
            for cd in ("float32", "bfloat16") for pal in (False, True)}
    return variables, example, outs


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 1), (1, 2)])
def test_bf16_eval_matches_its_jax_routing(unit_layers, graph_layers, use_kernels):
    variables, example, outs = jax_case(unit_layers, graph_layers)
    want, fp32 = outs[("bfloat16", use_kernels)], outs[("float32", use_kernels)]
    model = build_model(device="cpu", use_kernels=use_kernels, compute_dtype="bfloat16",
                        **dims(unit_layers, graph_layers, NODES))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    got = model(*(torch.from_numpy(a) for a in example))
    for field in got._fields:
        g = getattr(got, field)
        assert g.dtype == torch.float32, field
        np.testing.assert_allclose(g.numpy(), want[field], atol=ATOL, err_msg=field)
        gap = np.abs(want[field] - fp32[field]).max()
        assert gap >= 10 * ATOL, (field, gap)


def test_compute_dtype_switches_on_a_built_model():
    """Setting ``compute_dtype`` on a built model is building it so: the
    same weights, the same numbers; back to fp32 gives fp32's numbers."""
    variables, example, outs = jax_case(1, 1)
    kw = dims(1, 1, NODES)
    model = build_model(device="cpu", use_kernels=False, **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    args = [torch.from_numpy(a) for a in example]
    fp32 = model(*args).logits
    model.compute_dtype = "bfloat16"
    assert model.visual_motion_input_unit.stream_dtype is torch.bfloat16
    assert model.visual_input_unit.queryAttn[0].feat_enhance.__class__ is torch.nn.Linear  # not streamed
    np.testing.assert_allclose(model(*args).logits.numpy(), outs[("bfloat16", False)]["logits"], atol=ATOL)
    model.compute_dtype = "float32"
    assert torch.equal(model(*args).logits, fp32)
    with pytest.raises(ValueError, match="compute_dtype"):
        model.compute_dtype = "float16"


def test_model_upcasts_bf16_inputs():
    """bf16 visual features (the loader's ``transfer_dtype: bfloat16``) are
    upcast at entry: fp32 logits close to the fp32-input logits, and equal
    to the JAX package's on the same bf16 inputs (tests/test_transfer_dtype.py)."""
    variables, example, _ = jax_case(1, 1)
    kw = dims(1, 1, NODES)
    app, mot, q, qlen = example
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    model = build_model(device="cpu", **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    out32 = model(torch.from_numpy(app), torch.from_numpy(mot), torch.from_numpy(q), torch.from_numpy(qlen))
    out16 = model(bf(app), bf(mot), torch.from_numpy(q), torch.from_numpy(qlen))
    assert out16.logits.dtype == torch.float32
    np.testing.assert_allclose(out16.logits.numpy(), out32.logits.numpy(), atol=5e-2)
    want = JaxDualVGR(**kw).apply(variables, jnp.asarray(app, jnp.bfloat16), jnp.asarray(mot, jnp.bfloat16),
                                  q, qlen, train=False)
    np.testing.assert_allclose(out16.logits.numpy(), np.asarray(want.logits), atol=1e-4)
