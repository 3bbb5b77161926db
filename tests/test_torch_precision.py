"""The port's bf16 streaming (``ops/precision.py``) against the JAX package's.

The cases of tests/test_stream_dtype.py, each on the same numpy inputs
through the JAX function and the port's: streamed products round their
operands to bf16 and keep fp32 sums and outputs; their cotangents are
exact-f32 (bf16 operands, fp32 output, no rounding of the result), bitwise
equal to the products formed by hand; ``stream_roundtrip`` rounds forward
and passes the cotangent unrounded; the rounding is real on the CPU (a
streamed product differs from the fp32 one), so the closeness checks are
not vacuous; ``SLinear`` has ``nn.Linear``'s state_dict and, unstreamed,
its numbers. Port against JAX: atol 1e-5, the order of the fp32 sums over
at most 64 products of bf16 values; the closeness to fp32 at the JAX test's
tolerances.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualvgr_tpu.ops import precision as jprec
from dualvgr_tpu.ops.lstm import LSTMParams as JLSTMParams, time_major_input_proj as j_input_proj
from dualvgr_tpu_torch.ops import precision
from dualvgr_tpu_torch.ops.lstm import LSTMParams, time_major_input_proj

BF16 = torch.bfloat16
ATOL_JAX = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rounded(t):
    return t.to(BF16).float()


def test_stream_dtype_of():
    assert precision.stream_dtype_of(None) is None
    assert precision.stream_dtype_of("float32") is None
    assert precision.stream_dtype_of("bfloat16") is BF16
    assert jprec.stream_dtype_of("bfloat16") == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        precision.stream_dtype_of("float16")


def test_input_proj_bf16_close_to_fp32_and_to_jax(rng):
    b, t, d, h = 4, 7, 64, 16
    x = rng.randn(b, t, d).astype(np.float32)
    w_ih = (rng.randn(4 * h, d) * 0.2).astype(np.float32)
    b_ih, b_hh = (rng.randn(4 * h).astype(np.float32) for _ in range(2))
    w_hh = np.zeros((4 * h, h), np.float32)
    jp = JLSTMParams(jnp.asarray(w_ih.T), jnp.asarray(w_hh.T), jnp.asarray(b_ih), jnp.asarray(b_hh))
    tp = LSTMParams(*(_t(a) for a in (w_ih, w_hh, b_ih, b_hh)))
    ref = time_major_input_proj(_t(x), tp)
    got = time_major_input_proj(_t(x), tp, stream_dtype=BF16)
    assert got.dtype == torch.float32  # fp32 sum, fp32 bias
    np.testing.assert_allclose(got.numpy(), np.asarray(j_input_proj(jnp.asarray(x), jp, "bfloat16")),
                               atol=ATOL_JAX)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-2)
    # the reversed direction is the same projection flipped in time
    rev = time_major_input_proj(_t(x), tp, reverse=True, stream_dtype=BF16)
    assert torch.equal(rev, got.flip(0))


def test_streaming_applies_real_rounding_on_cpu(rng):
    """A streamed product differs from the fp32 one here, so every closeness
    check of the bf16 path tests real rounding."""
    x = _t(rng.randn(64, 128).astype(np.float32))
    w = _t(rng.randn(128, 96).astype(np.float32))
    diff = (x @ w - precision.streamed_matmul(x, w, BF16)).abs().max().item()
    assert diff > 1e-3


def test_streamed_matmul_grads_exact_f32(rng):
    x = rng.randn(6, 32).astype(np.float32)
    w = rng.randn(32, 16).astype(np.float32)
    c = rng.randn(6, 16).astype(np.float32)  # the cotangent
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = precision.streamed_matmul(tx, tw, BF16)
    (y * _t(c)).sum().backward()
    # exact-f32: rounded operands, fp32 products formed by hand, bitwise
    assert torch.equal(y.detach(), _rounded(_t(x)) @ _rounded(_t(w)))
    assert torch.equal(tx.grad, _rounded(_t(c)) @ _rounded(_t(w)).t())
    assert torch.equal(tw.grad, _rounded(_t(x)).t() @ _rounded(_t(c)))
    assert tx.grad.dtype == tw.grad.dtype == torch.float32
    # the cotangents are not bf16 values: rounding them changes them
    assert (tx.grad - _rounded(tx.grad)).abs().max() > 0
    assert (tw.grad - _rounded(tw.grad)).abs().max() > 0
    # and they are the JAX package's
    jdx, jdw = jax.grad(lambda a, b: (jprec.streamed_matmul(a, b, "bfloat16") * c).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=ATOL_JAX)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=ATOL_JAX)


def test_streamed_matmul_takes_leading_dims(rng):
    x = rng.randn(5, 3, 32).astype(np.float32)
    w = rng.randn(32, 16).astype(np.float32)
    got = precision.streamed_matmul(_t(x), _t(w), BF16)
    assert got.shape == (5, 3, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jprec.streamed_matmul(jnp.asarray(x), jnp.asarray(w),
                                                                              "bfloat16")), atol=ATOL_JAX)
    np.testing.assert_allclose(got.numpy(), x @ w, atol=0.15)
    assert torch.equal(precision.streamed_matmul(_t(x), _t(w), None), _t(x) @ _t(w))


def test_streamed_einsum_grads_exact_f32(rng):
    """The stacked-bank contraction of the JAX package's batched GATs."""
    spec = "kbnd,kdh->kbnh"
    x = rng.randn(4, 2, 3, 8).astype(np.float32)
    w = rng.randn(4, 8, 6).astype(np.float32)
    c = rng.randn(4, 2, 3, 6).astype(np.float32)
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    (precision.streamed_einsum(spec, tx, tw, BF16) * _t(c)).sum().backward()
    rc, rw, rx = _rounded(_t(c)), _rounded(_t(w)), _rounded(_t(x))
    assert torch.equal(tx.grad, torch.einsum("kbnh,kdh->kbnd", rc, rw))
    assert torch.equal(tw.grad, torch.einsum("kbnd,kbnh->kdh", rx, rc))
    assert (tx.grad - _rounded(tx.grad)).abs().max() > 0
    jdx, jdw = jax.grad(lambda a, b: (jprec.streamed_einsum(spec, a, b, "bfloat16") * c).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=ATOL_JAX)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=ATOL_JAX)


def test_transpose_specs_rejects_summed_only_index():
    assert precision._transpose_specs("btd,dh->tbh") == jprec._transpose_specs("btd,dh->tbh")
    with pytest.raises(ValueError, match="summed-only"):
        precision._transpose_specs("ij,jk->k")
    with pytest.raises(ValueError, match="summed-only"):
        precision.streamed_einsum("ij,jk->k", torch.ones(2, 3), torch.ones(3, 4), BF16)


def test_stream_roundtrip_rounds_forward_identity_backward(rng):
    x = rng.randn(32, 48).astype(np.float32)
    c = rng.randn(32, 48).astype(np.float32)
    tx = _t(x).requires_grad_()
    y = precision.stream_roundtrip(tx, BF16)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jprec.stream_roundtrip(jnp.asarray(x), "bfloat16")))
    assert torch.equal(y.detach(), _rounded(_t(x)))
    (y * _t(c)).sum().backward()
    assert torch.equal(tx.grad, _t(c))  # bitwise: the cotangent is not rounded


def test_slinear_is_an_nn_linear(rng):
    torch.manual_seed(0)
    ref = torch.nn.Linear(32, 16)
    lin = precision.SLinear(32, 16)
    lin.load_state_dict(ref.state_dict(), strict=True)
    assert list(lin.state_dict()) == list(ref.state_dict()) == ["weight", "bias"]
    assert list(precision.SLinear(32, 16, bias=False).state_dict()) == ["weight"]
    x = _t(rng.randn(5, 3, 32).astype(np.float32))
    assert lin.stream_dtype is None
    assert torch.equal(lin(x), ref(x))
    lin.stream_dtype = BF16
    got = lin(x)
    want = precision.streamed_matmul(x, ref.weight.t(), BF16) + ref.bias
    assert torch.equal(got, want)
    # the JAX SDense under a stream dtype, on the same weights
    import flax.linen as nn

    sd = jprec.SDense(16, stream="bfloat16")
    params = {"params": {"kernel": jnp.asarray(ref.weight.detach().numpy().T),
                         "bias": jnp.asarray(ref.bias.detach().numpy())}}
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(sd.apply(params, jnp.asarray(x.numpy()))),
                               atol=ATOL_JAX)
    assert isinstance(sd, nn.Module)
