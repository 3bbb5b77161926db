"""The port's BiLSTM against the JAX package's masked-scan BiLSTM.

Same numpy inputs through ``dualvgr_tpu.ops.lstm.bilstm`` (XLA path) and
the port's ``bilstm`` / ``bilstm_recurrence_reference`` on the CPU, fp32,
atol 1e-5 (the two frameworks sum the products in different orders). The
CUDA kernel is held against its plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualvgr_tpu.ops import lstm as jlstm
from dualvgr_tpu_torch.ops import lstm_kernel
from dualvgr_tpu_torch.ops.lstm import LSTMParams, bilstm, time_major_input_proj

ATOL = 1e-5


def _params(rng, d, h):
    """One direction: (JAX LSTMParams, the port's LSTMParams), same values."""
    w_ih = (rng.randn(4 * h, d) * 0.3).astype(np.float32)
    w_hh = (rng.randn(4 * h, h) * 0.3).astype(np.float32)
    b_ih = (rng.randn(4 * h) * 0.1).astype(np.float32)
    b_hh = (rng.randn(4 * h) * 0.1).astype(np.float32)
    j = jlstm.LSTMParams(jnp.asarray(w_ih.T), jnp.asarray(w_hh.T), jnp.asarray(b_ih), jnp.asarray(b_hh))
    t = LSTMParams(*(torch.from_numpy(a) for a in (w_ih, w_hh, b_ih, b_hh)))
    return j, t


def _case(rng, r, t, d, h):
    x = (rng.randn(r, t, d)).astype(np.float32)
    # every length 1..T appears
    lens = (np.arange(r) % t + 1).astype(np.int32)
    rng.shuffle(lens)
    jf, tf = _params(rng, d, h)
    jb, tb = _params(rng, d, h)
    return x, lens, (jf, jb), (tf, tb)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_bilstm_matches_jax(rng, masked, use_kernel):
    x, lens, (jf, jb), (tf, tb) = _case(rng, r=11, t=7, d=9, h=8)
    want_outs, want_final = jlstm.bilstm(jf, jb, jnp.asarray(x), jnp.asarray(lens) if masked else None)
    got_outs, got_final = bilstm(
        tf, tb, torch.from_numpy(x), torch.from_numpy(lens) if masked else None,
        use_kernel=use_kernel,
    )
    np.testing.assert_allclose(got_final.numpy(), np.asarray(want_final), atol=ATOL)
    np.testing.assert_allclose(got_outs.numpy(), np.asarray(want_outs), atol=ATOL)


def test_recurrence_reference_matches_jax(rng):
    """bilstm_recurrence_reference on the kernel contract (time-major gates,
    time-reversed backward gates, (H, 4H) weights), outputs and final."""
    x, lens, (jf, jb), (tf, tb) = _case(rng, r=13, t=6, d=5, h=4)
    want_outs, want_final = jlstm.bilstm(jf, jb, jnp.asarray(x), jnp.asarray(lens))
    xt = torch.from_numpy(x)
    xf = time_major_input_proj(xt, tf)
    xb = time_major_input_proj(xt, tb, reverse=True)
    # the reversed projection is the projection of the time-flipped input
    np.testing.assert_allclose(
        xb.numpy(), time_major_input_proj(xt.flip(1), tb).numpy(), atol=ATOL
    )
    final, outs = lstm_kernel.bilstm_recurrence_reference(
        xf, xb, tf.w_hh.t().contiguous(), tb.w_hh.t().contiguous(), torch.from_numpy(lens),
        with_outputs=True,
    )
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), atol=ATOL)
    np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), atol=ATOL)
    final_only = lstm_kernel.bilstm_recurrence_reference(
        xf, xb, tf.w_hh.t().contiguous(), tb.w_hh.t().contiguous(), torch.from_numpy(lens)
    )
    np.testing.assert_array_equal(final_only.numpy(), final.numpy())


def test_wrapper_takes_plain_version_on_cpu_without_counting(rng):
    """On CPU tensors the wrapper runs the plain version; only a kernel
    launch adds to the count."""
    x, lens, _, (tf, tb) = _case(rng, r=5, t=4, d=3, h=4)
    xt = torch.from_numpy(x)
    args = (time_major_input_proj(xt, tf), time_major_input_proj(xt, tb, reverse=True),
            tf.w_hh.t().contiguous(), tb.w_hh.t().contiguous(), torch.from_numpy(lens))
    before = lstm_kernel.bilstm_recurrence.launches
    got = lstm_kernel.bilstm_recurrence(*args, with_outputs=True)
    want = lstm_kernel.bilstm_recurrence_reference(*args, with_outputs=True)
    assert lstm_kernel.bilstm_recurrence.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())



@pytest.mark.slow
def test_recurrence_reference_matches_pallas_interpret(rng):
    """The port's plain recurrence against the TPU kernel itself, run in
    Pallas interpret mode on the CPU, on the same kernel inputs."""
    from dualvgr_tpu.ops.lstm_pallas import bilstm_pallas

    t, r, h = 5, 9, 8
    xf, xb = (rng.randn(t, r, 4 * h).astype(np.float32) for _ in range(2))
    wf, wb = ((rng.randn(h, 4 * h) * 0.3).astype(np.float32) for _ in range(2))
    lens = rng.randint(1, t + 1, (r,)).astype(np.int32)
    want_final, want_outs = bilstm_pallas(
        *(jnp.asarray(a) for a in (xf, xb, wf, wb, lens)), with_outputs=True, block_r=4,
        interpret=True,
    )
    final, outs = lstm_kernel.bilstm_recurrence_reference(
        *(torch.from_numpy(a) for a in (xf, xb, wf, wb, lens)), with_outputs=True
    )
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), atol=ATOL)
    np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), atol=ATOL)
