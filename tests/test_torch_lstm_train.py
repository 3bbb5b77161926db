"""The port's trainable BiLSTM against the JAX package's Pallas kernel pair.

* The plain versions of kernels 3 and 4 (``bilstm_train_fwd_reference``,
  ``bilstm_train_bwd_reference``) against the TPU kernels ``_run_fwd_m`` and
  ``_run_bwd_m`` themselves, run in Pallas interpret mode on the CPU, on the
  same numpy inputs, in the three modes of the model's train step, with
  every length 1..T. The TPU kernel keeps the backward half of ``outs`` in
  kernel time; the port keeps it in original time (kernel 1's layout), and
  the test converts explicitly, both ways.
* ``BiLSTMTrainable`` against torch.autograd through the plain recurrence
  of the eval path (an independent check), and a float64 gradcheck.
* ``AppearanceBiLSTMTrain`` against the JAX ``appearance_bilstm_train``
  (interpret mode) on dW_ih, db and dW_hh; it refuses an x that requires grad.

fp32, atol 1e-5 against the kernels' recurrence and 1e-4 where a projection
over D sits in the gradient (as tests/test_pallas_train.py:250): the two
frameworks sum the products in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dualvgr_tpu.ops.lstm_pallas_train as lpt
from dualvgr_tpu_torch.ops import lstm_kernel, lstm_train, lstm_train_kernel

ATOL = 1e-5
ATOL_PROJ = 1e-4
T, R, H = 5, 6, 8


@pytest.fixture
def interpret():
    lpt.INTERPRET = True
    yield
    lpt.INTERPRET = False


def _kernel_inputs(rng, t=T, r=R, h=H, dtype=np.float32):
    xf, xb = (rng.randn(t, r, 4 * h).astype(dtype) for _ in range(2))
    wf, wb = ((rng.randn(h, 4 * h) * 0.3).astype(dtype) for _ in range(2))
    # every length 1..T appears
    lens = (np.arange(r) % t + 1).astype(np.int32)
    rng.shuffle(lens)
    return xf, xb, wf, wb, lens


def _to_kernel_time(outs, h):
    """The port's outs (R, T, 2H), backward half in original time -> the TPU
    kernel's (T, R, 2H), both halves in kernel time."""
    return np.concatenate([outs[:, :, :h], outs[:, ::-1, h:]], axis=-1).transpose(1, 0, 2)


@pytest.mark.parametrize("masked,with_outputs", [
    (False, False),  # the appearance encoder
    (True, True),    # concatRNN
    (True, False),   # the question encoder
])
def test_reference_pair_matches_pallas_interpret(rng, interpret, masked, with_outputs):
    xf, xb, wf, wb, lens = _kernel_inputs(rng)
    dfinal = rng.randn(R, 2 * H).astype(np.float32)
    douts = rng.randn(R, T, 2 * H).astype(np.float32) if with_outputs else None
    jlens = jnp.asarray(lens.astype(np.float32)[:, None] if masked else np.zeros((R, 1), np.float32))
    j = [jnp.asarray(a) for a in (xf, xb, wf, wb)]

    want_final, want_outs, want_hprev, want_cprev = lpt._run_fwd_m(*j, jlens, R, masked, with_outputs)
    jdouts = jnp.asarray(_to_kernel_time(douts, H)) if with_outputs else jnp.zeros((1, R, 2 * H))
    want_dxf, want_dxb, want_dwf, want_dwb = lpt._run_bwd_m(
        *j, jlens, want_hprev, want_cprev, jnp.asarray(dfinal), jdouts, R, masked, with_outputs
    )

    t_in = [torch.from_numpy(a) for a in (xf, xb, wf, wb)]
    t_lens = torch.from_numpy(lens) if masked else None
    final, outs, hprev, cprev, acts = lstm_train_kernel.bilstm_train_fwd_reference(
        *t_in, t_lens, with_outputs=with_outputs
    )
    np.testing.assert_allclose(final.numpy(), np.asarray(want_final), atol=ATOL)
    np.testing.assert_allclose(hprev.numpy(), np.asarray(want_hprev), atol=ATOL)
    np.testing.assert_allclose(cprev.numpy(), np.asarray(want_cprev), atol=ATOL)
    if with_outputs:
        np.testing.assert_allclose(_to_kernel_time(outs.numpy(), H), np.asarray(want_outs), atol=ATOL)
    else:
        assert outs is None

    dxf, dxb = lstm_train_kernel.bilstm_train_bwd_reference(
        acts, *t_in[2:], t_lens, cprev, torch.from_numpy(dfinal),
        torch.from_numpy(douts) if with_outputs else None,
    )
    np.testing.assert_allclose(dxf.numpy(), np.asarray(want_dxf), atol=ATOL)
    np.testing.assert_allclose(dxb.numpy(), np.asarray(want_dxb), atol=ATOL)
    dwf, dwb = lstm_train.recurrent_weight_grads(hprev, dxf, dxb)
    np.testing.assert_allclose(dwf.numpy(), np.asarray(want_dwf), atol=ATOL)
    np.testing.assert_allclose(dwb.numpy(), np.asarray(want_dwb), atol=ATOL)
    if masked:
        # the dgates of a masked step are exactly zero
        steps = np.arange(T)[:, None]
        assert not dxf.numpy()[steps >= lens[None, :]].any()
        assert not dxb.numpy()[steps < T - lens[None, :]].any()


def _plain_lstm_by_row(xf, xb, wf, wb, lens, with_outputs):
    """A plain fp32 BiLSTM written apart from the port's: one row at a time
    over its valid steps only, so autograd never touches a padded gate.
    ``(final, outs)`` in the trainable op's layout."""
    t_total, r, g = xf.shape
    h = g // 4

    def run(x, w, row, steps):
        hh, c, hs = x.new_zeros(h), x.new_zeros(h), []
        for t in steps:
            i, f, gg, o = (x[t, row] + hh @ w).chunk(4)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            hh = torch.sigmoid(o) * torch.tanh(c)
            hs.append(hh)
        return hh, hs

    finals, outs = [], []
    for row in range(r):
        n = t_total if lens is None else int(lens[row])
        hf, hs_f = run(xf, wf, row, range(n))
        # the backward direction's kernel step t is original time T - 1 - t
        hb, hs_b = run(xb, wb, row, range(t_total - n, t_total))
        finals.append(torch.cat([hf, hb]))
        if with_outputs:
            pad = [xf.new_zeros(2 * h)] * (t_total - n)
            outs.append(torch.stack([torch.cat(p) for p in zip(hs_f, hs_b[::-1])] + pad))
    return torch.stack(finals), (torch.stack(outs) if with_outputs else None)


@pytest.mark.parametrize("masked,with_outputs,h,nan_padding", [
    (False, False, 16, False),
    (False, True, 16, False),
    (True, True, 16, False),
    (True, False, 16, False),
    (False, False, 384, False),
    (True, True, 384, False),
    (True, True, 16, True),    # the padding's gates NaN: the stored activations stay finite
    (True, False, 384, True),
])
def test_dgates_from_stored_activations_match_autograd_of_a_plain_lstm(rng, masked, with_outputs, h, nan_padding):
    """The trainable op, whose backward reads the activations its forward
    stored (zero at a masked step), against autograd of a plain fp32 LSTM:
    the outputs, the dgates (the gate inputs' gradients) and dW_hh."""
    t, r = 5, 6
    xf, xb, wf, wb, lens = _kernel_inputs(rng, t=t, r=r, h=h)
    wf, wb = (w * np.float32(2.0 / np.sqrt(h)) for w in (wf, wb))
    if nan_padding:
        steps = np.arange(t)[:, None]
        xf[steps >= lens[None, :]] = np.nan
        xb[steps < t - lens[None, :]] = np.nan
    t_lens = torch.from_numpy(lens) if masked else None
    cot_f = torch.from_numpy(rng.randn(r, 2 * h).astype(np.float32))
    cot_o = torch.from_numpy(rng.randn(r, t, 2 * h).astype(np.float32))

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (xf, xb, wf, wb)]
        final, outs = fn(*leaves, t_lens, with_outputs)
        loss = (final * cot_f).sum() + ((outs * cot_o).sum() if with_outputs else 0.0)
        loss.backward()
        return [final, outs] + [p.grad for p in leaves]

    got = run(lambda *a: lstm_train.bilstm_trainable(*a[:5], with_outputs=a[5]))
    want = run(_plain_lstm_by_row)
    for g, w, name in zip(got, want, ("final", "outs", "dxf", "dxb", "dwf", "dwb")):
        if w is None:
            assert g is None, name
            continue
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=1e-5, atol=ATOL, err_msg=name)

    *_, acts = lstm_train_kernel.bilstm_train_fwd_reference(*(torch.from_numpy(a) for a in (xf, xb, wf, wb)),
                                                             t_lens, with_outputs=with_outputs)
    assert acts.shape == (2, t, r, 4 * h) and torch.isfinite(acts).all()
    if masked:
        steps = torch.arange(t)[:, None]
        t_lens = t_lens[None, :]
        assert not acts[0][steps >= t_lens].any() and not acts[1][steps < t - t_lens].any()


def _plain_bilstm(xf, xb, wf, wb, lens, with_outputs):
    """torch.autograd through the eval path's plain recurrence."""
    res = lstm_kernel.bilstm_recurrence_reference(xf, xb, wf, wb, lens, with_outputs=with_outputs)
    return res if with_outputs else (res, None)


@pytest.mark.parametrize("masked,with_outputs", [(False, False), (True, True), (True, False), (False, True)])
def test_trainable_matches_autograd_of_plain_recurrence(rng, masked, with_outputs):
    xf, xb, wf, wb, lens = _kernel_inputs(rng, t=6, r=7)
    tgt_f = torch.from_numpy(rng.randn(7, 2 * H).astype(np.float32))
    tgt_o = torch.from_numpy(rng.randn(7, 6, 2 * H).astype(np.float32))
    t_lens = torch.from_numpy(lens) if masked else None

    def run(fn):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (xf, xb, wf, wb)]
        final, outs = fn(*leaves, t_lens, with_outputs)
        loss = ((final - tgt_f) ** 2).sum()
        if with_outputs:
            loss = loss + ((outs - tgt_o) ** 2).sum()
        loss.backward()
        return [final, outs] + [p.grad for p in leaves]

    before = (lstm_train_kernel.bilstm_train_fwd.launches, lstm_train_kernel.bilstm_train_bwd.launches)
    got = run(lambda *a: lstm_train.bilstm_trainable(*a[:5], with_outputs=a[5]))
    want = run(_plain_bilstm)
    # CPU tensors: the wrappers ran their plain versions, no kernel
    assert (lstm_train_kernel.bilstm_train_fwd.launches, lstm_train_kernel.bilstm_train_bwd.launches) == before
    for g, w, name in zip(got, want, ("final", "outs", "dxf", "dxb", "dwf", "dwb")):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), atol=ATOL, err_msg=name)


def test_trainable_gradcheck_float64(rng):
    xf, xb, wf, wb, _ = _kernel_inputs(rng, t=3, r=2, h=4, dtype=np.float64)
    lens = torch.tensor([3, 1])
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xf, xb, wf, wb)]

    def fn(a, b, c, d):
        final, outs = lstm_train.bilstm_trainable(a, b, c, d, lens, with_outputs=True)
        return final, outs

    assert torch.autograd.gradcheck(fn, leaves, eps=1e-6, atol=1e-6)
    assert torch.autograd.gradcheck(
        lambda *a: lstm_train.bilstm_trainable(*a, None, with_outputs=False)[0], leaves,
        eps=1e-6, atol=1e-6,
    )


def test_appearance_op_matches_pallas_interpret(rng, interpret):
    r, t, d, h = 6, 5, 8, 4
    x = rng.randn(r, t, d).astype(np.float32)
    # torch layouts: w_ih (4H, D), combined bias (4H,), w_hh (4H, H)
    w = {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in (
        ("wih_f", (4 * h, d)), ("b_f", (4 * h,)), ("whh_f", (4 * h, h)),
        ("wih_b", (4 * h, d)), ("b_b", (4 * h,)), ("whh_b", (4 * h, h)))}
    tgt = rng.randn(r, 2 * h).astype(np.float32)
    order = ("wih_f", "b_f", "whh_f", "wih_b", "b_b", "whh_b")

    import jax

    def jloss(args):
        wif, bf, whf, wib, bb, whb = args
        f = lpt.appearance_bilstm_train(jnp.asarray(x), wif.T, bf, whf.T, wib.T, bb, whb.T, block_r=r)
        return ((f - tgt) ** 2).sum(), f

    (_, want_final), want = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(w[k]) for k in order)
    )

    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    final = lstm_train.appearance_bilstm_train(
        torch.from_numpy(x), leaves["wih_f"], leaves["b_f"], leaves["whh_f"].t().contiguous(),
        leaves["wih_b"], leaves["b_b"], leaves["whh_b"].t().contiguous(),
    )
    ((final - torch.from_numpy(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(final.detach().numpy(), np.asarray(want_final), atol=ATOL)
    for k, g in zip(order, want):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g), atol=ATOL_PROJ, err_msg=k)

    with pytest.raises(RuntimeError, match="requires grad"):
        lstm_train.appearance_bilstm_train(
            torch.from_numpy(x).requires_grad_(), *(leaves[k] for k in order[:2]),
            leaves["whh_f"].t().contiguous(), *(leaves[k] for k in order[3:5]),
            leaves["whh_b"].t().contiguous(),
        )


@pytest.mark.parametrize("fn", ["bilstm_recurrence", "bilstm_train_fwd"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(rng, fn):
    """A wrapper records nothing for autograd, so with grad mode on it refuses
    an input that requires grad (on a CPU tensor too: the check comes before
    the device dispatch); under no_grad it runs."""
    xf, xb, wf, wb, lens = (torch.from_numpy(a) for a in _kernel_inputs(rng))
    wrapper = getattr(lstm_kernel, fn, None) or getattr(lstm_train_kernel, fn)
    wf.requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        wrapper(xf, xb, wf, wb, lens)
    with torch.no_grad():
        wrapper(xf, xb, wf, wb, lens)


def test_gat_cycle_refuses_inputs_that_require_grad(rng):
    """The graph-cycle kernel is eval only (the JAX package gives the TPU
    kernel no backward): with grad mode on it refuses an input that
    requires grad, on a CPU tensor too."""
    from dualvgr_tpu_torch.ops import gat_kernel

    b, n, d, heads = 2, 3, 8, 2
    hd = d // heads
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    args = [t(b, n, hd), t(d, d), t(d), t(heads, 2 * hd), t(heads), t(d, d), t(d), t(heads, 2 * hd),
            t(heads), t(d, d), t(d), t(d, 1)]
    h = t(b, n, d).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        gat_kernel.gat_cycle(h, *args)
    with torch.no_grad():
        gat_kernel.gat_cycle(h, *args)
