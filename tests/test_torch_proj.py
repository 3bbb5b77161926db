"""The plain versions of kernels 5 and 6 against the TPU kernels themselves.

``benchmarks/proj_probe.py``'s two Pallas kernels (``make_pallas_proj``,
``make_pallas_both``) run on the CPU under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``; the port's
``input_proj_one_reference`` and ``input_proj_both_reference`` get the same
numpy inputs: x (R, T, D), the torch-layout w_ih (4H, D) (its transpose,
rounded to bf16, for the TPU kernels) and the fp32 bias. Both time orders
and both tanh forms, at R a multiple of the kernels' ``block_r``. The
outputs are bf16 and are compared for equality: both sides round the same
operands to bf16, sum 32 exact products in fp32 and round once after the
bias, and at these inputs no fp32 sum order moves a result across a bf16
rounding boundary. The first step of both TPU kernels, ``tanh(x)`` rounded
to bf16 (``benchmarks/proj_probe.py:79, 124``), is the port's tanh pass,
whose plain version is held against ``jnp.tanh(x).astype(bfloat16)`` bit
for bit on the same inputs. The wrappers run the plain versions on CPU
tensors and launch nothing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmarks.proj_probe import make_pallas_both, make_pallas_proj
from dualvgr_tpu_torch.ops import proj_kernel

T, R, D, G, BLOCK_R = 3, 16, 32, 64, 8


@pytest.fixture
def data(rng):
    x = rng.randn(R, T, D).astype(np.float32)
    w_f, w_b = ((rng.randn(G, D) * 0.3).astype(np.float32) for _ in range(2))
    b_f, b_b = (rng.randn(G).astype(np.float32) for _ in range(2))
    return x, w_f, b_f, w_b, b_b


def _jw(w):
    """The TPU kernels' layout: (D, 4H) bf16."""
    return jnp.asarray(w.T).astype(jnp.bfloat16)


def _bits(a):
    """bf16 values as their 16-bit patterns, for an exact comparison."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("reverse", [False, True])
def test_kernel5_reference_matches_pallas(data, reverse):
    x, w_f, b_f, _, _ = data
    with pltpu.force_tpu_interpret_mode():
        want = make_pallas_proj(T, R, D, G, BLOCK_R, reverse_time=reverse)(
            jnp.asarray(x), _jw(w_f), jnp.asarray(b_f))
    got = proj_kernel.input_proj_one_reference(torch.from_numpy(x), torch.from_numpy(w_f),
                                               torch.from_numpy(b_f), reverse=reverse)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, R, G)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fuse_tanh", [True, False])
def test_kernel6_reference_matches_pallas(data, fuse_tanh):
    x, w_f, b_f, w_b, b_b = data
    # the unfused form takes x already tanh'd and in bf16
    x_in = x if fuse_tanh else np.tanh(x)
    with pltpu.force_tpu_interpret_mode():
        want_f, want_b = make_pallas_both(T, R, D, G, BLOCK_R, fuse_tanh=fuse_tanh)(
            jnp.asarray(x_in), _jw(w_f), jnp.asarray(b_f), _jw(w_b), jnp.asarray(b_b))
    tx = torch.from_numpy(x_in)
    if not fuse_tanh:
        tx = tx.to(torch.bfloat16)
    args = [torch.from_numpy(a) for a in (w_f, b_f, w_b, b_b)]
    got_f, got_b = proj_kernel.input_proj_both_reference(tx, *args, fuse_tanh=fuse_tanh)
    np.testing.assert_array_equal(_bits(got_f), _bits(want_f))
    np.testing.assert_array_equal(_bits(got_b), _bits(want_b))
    # the backward direction is written time-reversed: kernel 5's reversed form
    if fuse_tanh:
        assert torch.equal(got_b, proj_kernel.input_proj_one_reference(tx, args[2], args[3], reverse=True))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_tanh_pass_reference_matches_jax(data, scale):
    """The plain tanh pass equals JAX's ``tanh`` rounded to bf16, bit for
    bit (scale 3 puts most values in tanh's flat tails)."""
    x = data[0] * scale
    got = proj_kernel.tanh_to_bf16_reference(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_bits(got), _bits(jnp.tanh(jnp.asarray(x)).astype(jnp.bfloat16)))


def test_plain_versions_take_the_tanh_pass_first(data):
    """Kernels 5 and 6 on fp32 x are the tanh pass, then the product on its
    bf16 output: the two-step form the card runs."""
    x, w_f, b_f, w_b, b_b = (torch.from_numpy(a) for a in data)
    x16 = proj_kernel.tanh_to_bf16_reference(x)
    two_step = proj_kernel.input_proj_both_reference(x16, w_f, b_f, w_b, b_b, fuse_tanh=False)
    assert torch.equal(proj_kernel.input_proj_one_reference(x, w_b, b_b, reverse=True), two_step[1])
    for got, want in zip(proj_kernel.input_proj_both_reference(x, w_f, b_f, w_b, b_b), two_step):
        assert torch.equal(got, want)


def test_one_rounding_after_the_bias(data):
    """The function rounds once, after the fp32 bias: a bf16 product rounded
    before the bias (what a bf16 ``torch.matmul`` returns) differs."""
    x, w_f, b_f, _, _ = data
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w_f, b_f))
    got = proj_kernel.input_proj_one_reference(tx, tw, tb)
    a16, w16 = torch.tanh(tx).to(torch.bfloat16), tw.to(torch.bfloat16)
    twice = ((torch.einsum("rtd,gd->trg", a16.float(), w16.float()).to(torch.bfloat16).float() + tb)
             .to(torch.bfloat16))
    assert not torch.equal(got, twice)


def test_wrappers_run_the_plain_versions_on_cpu(data):
    x, w_f, b_f, w_b, b_b = (torch.from_numpy(a) for a in data)
    n0 = (proj_kernel.input_proj_one.launches, proj_kernel.input_proj_both.launches,
          proj_kernel.tanh_to_bf16.launches)
    assert torch.equal(proj_kernel.tanh_to_bf16(x), proj_kernel.tanh_to_bf16_reference(x))
    assert torch.equal(proj_kernel.input_proj_one(x, w_f, b_f, reverse=True),
                       proj_kernel.input_proj_one_reference(x, w_f, b_f, reverse=True))
    for fuse, xin in ((True, x), (False, torch.tanh(x).to(torch.bfloat16))):
        got = proj_kernel.input_proj_both(xin, w_f, b_f, w_b, b_b, fuse_tanh=fuse)
        want = proj_kernel.input_proj_both_reference(xin, w_f, b_f, w_b, b_b, fuse_tanh=fuse)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (proj_kernel.input_proj_one.launches, proj_kernel.input_proj_both.launches,
            proj_kernel.tanh_to_bf16.launches) == n0
    # the wrappers record nothing for autograd
    with pytest.raises(RuntimeError, match="autograd"):
        proj_kernel.tanh_to_bf16(x.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="autograd"):
        proj_kernel.input_proj_both(x, w_f.requires_grad_(), b_f, w_b, b_b)
