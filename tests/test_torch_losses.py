"""The port's training losses against the JAX package's ``ops/losses.py``.

Same numpy inputs, a ``valid`` mask that pads the last 2 rows: cross
entropy, common loss, HSIC and the total, their values and their gradients
with respect to every input. Includes the exactly-zero row of the common
loss (all nodes equal, so the centered row is zero), where the clamp before
the rsqrt keeps the gradient finite. fp32, rtol 1e-5 / atol 1e-6 (sums in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualvgr_tpu.ops import losses as jlosses
from dualvgr_tpu_torch.ops import losses as tlosses

B, N, D, A, T = 6, 4, 5, 7, 2
RTOL, ATOL = 1e-5, 1e-6


def _valid():
    v = np.ones(B, np.float32)
    v[-2:] = 0.0
    return v


def _check(jfn, tfn, arrays, valid):
    """Value and input gradients of jfn vs tfn on the same float arrays."""
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want, jgrads = jax.value_and_grad(lambda *a: jfn(*a, jv), argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays)
    )
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = tfn(*leaves, tv)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    for leaf, g in zip(leaves, jgrads):
        assert torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [True, False])
def test_cross_entropy(rng, masked):
    logits = rng.randn(B, A).astype(np.float32)
    labels = rng.randint(0, A, (B,)).astype(np.int32)
    _check(lambda lg, v: jlosses.cross_entropy_loss(lg, jnp.asarray(labels), v),
           lambda lg, v: tlosses.cross_entropy_loss(lg, torch.from_numpy(labels), v),
           [logits], _valid() if masked else None)


@pytest.mark.parametrize("zero_row", [False, True])
def test_common_loss(rng, zero_row):
    e1, e2 = (rng.randn(B, N, D).astype(np.float32) for _ in range(2))
    if zero_row:
        # every node of sample 0 equal: the centered rows are exactly zero
        e1[0] = e1[0, :1]
    _check(jlosses.common_loss, tlosses.common_loss, [e1, e2], _valid())


def test_hsic_dependence_loss(rng):
    e1, e2 = (rng.randn(B, N, D).astype(np.float32) for _ in range(2))
    _check(lambda a, b, v: jlosses.hsic_dependence_loss(a, b, N, v),
           lambda a, b, v: tlosses.hsic_dependence_loss(a, b, N, v), [e1, e2], _valid())


@pytest.mark.parametrize("masked", [True, False])
def test_total_loss(rng, masked):
    logits = rng.randn(B, A).astype(np.float32)
    labels = rng.randint(0, A, (B,)).astype(np.int32)
    stacks = [rng.randn(T, B, N, D).astype(np.float32) for _ in range(4)]
    stacks[1][0, 0] = stacks[1][0, 0, :1]  # a zero row in com_app

    def jfn(lg, aq, ca, mq, cm, v):
        total, aux = jlosses.dualvgr_total_loss(lg, jnp.asarray(labels), aq, ca, mq, cm, alpha=0.7,
                                                beta=1e-3, num_of_nodes=N, valid=v)
        return total

    def tfn(lg, aq, ca, mq, cm, v):
        total, aux = tlosses.dualvgr_total_loss(lg, torch.from_numpy(labels), aq, ca, mq, cm, alpha=0.7,
                                                beta=1e-3, num_of_nodes=N, valid=v)
        assert sorted(aux) == ["ce", "common", "dependence"]
        return total

    _check(jfn, tfn, [logits, *stacks], _valid() if masked else None)
