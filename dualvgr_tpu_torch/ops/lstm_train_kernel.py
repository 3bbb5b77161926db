"""The trainable BiLSTM recurrence: hand-written CUDA kernels and plain versions.

The kernel half of ``dualvgr_tpu/ops/lstm_pallas_train.py``:

* ``bilstm_train_fwd`` replaces ``_run_fwd_m`` (body ``_fwd_kernel_m``):
  kernel 1's recurrence (``ops/lstm_kernel.py``), which also stores the
  pre-step states ``(h_{t-1}, c_{t-1})`` of every step as residuals, and
  the gate activations. Returns ``(final, outs, hprev, cprev, acts)``:
  final (R, 2H); outs (R, T, 2H) or None, zero at padding, the backward
  half back in original time order (kernel 1's layout; the TPU kernel
  keeps it in kernel time and flips it outside); hprev and cprev (T, R,
  2H) in kernel time for both directions; acts (2, T, R, 4H), the
  activations sigmoid i, sigmoid f, tanh g, sigmoid o of each step,
  direction-major, each in kernel time, zero at a masked step (so the
  backward's m = 0 meets nothing non-finite, whatever the padding's gates
  hold).
* ``bilstm_train_bwd`` replaces ``_run_bwd_m`` (body ``_bwd_kernel_m``): the
  reverse-time backward. It reads the forward's activations and c_{t-1}
  (where the TPU kernel recomputes the gates from the inputs and h_{t-1}),
  carries ``(dh, dc)`` and returns ``(dxf, dxb)``, the gradients of the
  gate inputs (T, R, 4H) in kernel time, which are the dgates. ``douts``
  is read in the layout ``outs`` has. dW_hh is left to one plain product
  outside (``ops/lstm_train.py``) over hprev, as the JAX package leaves it
  to XLA.

The forward's inputs are kernel 1's: gates ``xf`` (T, R, 4H) and
time-reversed ``xb_rev``, recurrent weights ``w_hh_*`` (H, 4H), optional
(R,) lengths. The gates may be fp32 or bf16 (the appearance op under
``compute_dtype: bfloat16``, ``lstm_pallas_train.py:392-405``); the
weights, the residuals, the activations, ``final``, ``outs`` and the
dgates are fp32 either way, as in the TPU kernels, so the backward has
one type. On a CPU tensor each wrapper runs its ``*_reference``,
the plain PyTorch loop; on a CUDA tensor it launches
``csrc/bilstm_train_fwd.cu`` or ``csrc/bilstm_train_bwd.cu`` through the
shared launch (``ops/launch.py``) or raises. Both
are thread-block cluster kernels with each CTA's slice of W_hh resident in
shared memory; their launch plans (``recurrence_plan``, ``backward_plan``
in ``ops/lstm_kernel.py``) are computed here and checked by the C entries.
Both record nothing for autograd (``refuse_autograd``); the Functions of
``ops/lstm_train.py`` call them. What bounds each kernel and what its design does about it is
written at the top of its source.
"""

from __future__ import annotations

import torch

from dualvgr_tpu_torch.ops.launch import check, dispatch, int32_lengths, launch, ptr, refuse_autograd
from dualvgr_tpu_torch.ops.lstm_kernel import (
    backward_plan, gate_dtype_code, gate_hidden, launch_plan, plan_args, recurrence_loop,
)
from dualvgr_tpu_torch.utils.trace import count


def bilstm_train_fwd_reference(xf, xb_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False):
    """Plain PyTorch version of the training forward, with the kernel's contract."""
    return recurrence_loop(xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs,
                           keep_states=True)


def bilstm_train_bwd_reference(acts, w_hh_f, w_hh_b, lengths, cprev, dfinal, douts=None):
    """Plain PyTorch version of the training backward, with the kernel's contract.

    With ``m`` the step's mask (1 without lengths), a masked step passes
    ``(1 - m)`` of the carried gradients straight to the previous step:
    ``dh~ = m (dh + m dout)``, ``dh_prev += (1 - m)(dh + m dout)``,
    ``dc~ = m dc``, ``dc_prev += (1 - m) dc``, so the dgates of a masked
    step are exactly zero.
    """
    _, t_total, r, g = acts.shape
    hidden = g // 4
    if lengths is not None:
        lens = lengths.to(device=acts.device, dtype=torch.int64).view(r, 1)
    one = w_hh_f.new_ones(())
    dxs = []
    for k, w in enumerate((w_hh_f, w_hh_b)):
        cols = slice(k * hidden, (k + 1) * hidden)
        dx = w.new_empty(acts.shape[1:])
        dh, dc = dfinal[:, cols], w.new_zeros((r, hidden))
        for t in reversed(range(t_total)):
            c_prev = cprev[t, :, cols]
            i, f, gc, o = acts[k, t].chunk(4, dim=-1)
            tc = torch.tanh(f * c_prev + i * gc)
            if lengths is None:
                m = one
            else:
                m = ((t < lens) if k == 0 else (t >= t_total - lens)).to(w.dtype)
            dh_tot = dh if douts is None else dh + m * douts[:, t if k == 0 else t_total - 1 - t, cols]
            dh_in, dc_in = m * dh_tot, m * dc
            dcell = dc_in + dh_in * o * (1.0 - tc * tc)
            dgates = torch.cat([
                dcell * gc * i * (1.0 - i),
                dcell * c_prev * f * (1.0 - f),
                dcell * i * (1.0 - gc * gc),
                dh_in * tc * o * (1.0 - o),
            ], dim=-1)
            dx[t] = dgates
            dh = (1.0 - m) * dh_tot + dgates @ w.t()
            dc = (1.0 - m) * dc + dcell * f
        dxs.append(dx)
    return dxs[0], dxs[1]


def bilstm_train_fwd(xf, xb_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False):
    """Training forward (see the module docstring): ``(final, outs, hprev, cprev, acts)``.
    On the card it counts the bytes of activations it keeps in the
    tracer's ``lstm.gate_acts_bytes``."""
    refuse_autograd("bilstm_train_fwd", xf, xb_rev, w_hh_f, w_hh_b)
    run = dispatch("bilstm_train_fwd", xf, bilstm_train_fwd_reference, _fwd_cuda)
    return run(xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs)


def _fwd_cuda(xf, xb_rev, w_hh_f, w_hh_b, lengths, *, with_outputs):
    dev = xf.device
    if xf.dim() != 3:
        raise ValueError(f"xf must be (T, R, 4H), got {tuple(xf.shape)}")
    t_total, r, g = xf.shape
    hidden = gate_hidden(g)
    code = gate_dtype_code("xf", xf)
    check("xf", xf, (t_total, r, g), dev, xf.dtype)
    check("xb_rev", xb_rev, (t_total, r, g), dev, xf.dtype)
    check("w_hh_f", w_hh_f, (hidden, g), dev)
    check("w_hh_b", w_hh_b, (hidden, g), dev)
    lengths = int32_lengths(lengths, r, dev)
    final = torch.empty((r, 2 * hidden), device=dev, dtype=torch.float32)
    outs = torch.empty((r, t_total, 2 * hidden), device=dev, dtype=torch.float32) if with_outputs else None
    hprev, cprev = (torch.empty((t_total, r, 2 * hidden), device=dev, dtype=torch.float32) for _ in range(2))
    acts = torch.empty((2, t_total, r, g), device=dev, dtype=torch.float32)
    plan = launch_plan("bilstm_train_fwd", r, hidden, code, dev)
    launch(bilstm_train_fwd, "bilstm_train_fwd_launch", dev,
           xf.data_ptr(), xb_rev.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(), ptr(lengths),
           final.data_ptr(), ptr(outs), hprev.data_ptr(), cprev.data_ptr(), acts.data_ptr(),
           t_total, r, hidden, code, *plan_args(plan))
    count("lstm.gate_acts_bytes", acts.numel() * acts.element_size())
    return final, outs, hprev, cprev, acts


def bilstm_train_bwd(acts, w_hh_f, w_hh_b, lengths, cprev, dfinal, douts=None):
    """Training backward (see the module docstring): ``(dxf, dxb)`` from the
    forward's ``acts`` and ``cprev``. ``douts`` is None for a final-only
    forward and is then never read."""
    refuse_autograd("bilstm_train_bwd", acts, w_hh_f, w_hh_b, cprev, dfinal, douts)
    run = dispatch("bilstm_train_bwd", acts, bilstm_train_bwd_reference, _bwd_cuda)
    return run(acts, w_hh_f, w_hh_b, lengths, cprev, dfinal, douts)


def _bwd_cuda(acts, w_hh_f, w_hh_b, lengths, cprev, dfinal, douts):
    dev = acts.device
    if acts.dim() != 4 or acts.shape[0] != 2:
        raise ValueError(f"acts must be (2, T, R, 4H), got {tuple(acts.shape)}")
    _, t_total, r, g = acts.shape
    hidden = gate_hidden(g)
    check("acts", acts, (2, t_total, r, g), dev)
    check("w_hh_f", w_hh_f, (hidden, g), dev)
    check("w_hh_b", w_hh_b, (hidden, g), dev)
    check("cprev", cprev, (t_total, r, 2 * hidden), dev)
    check("dfinal", dfinal, (r, 2 * hidden), dev)
    if douts is not None:
        check("douts", douts, (r, t_total, 2 * hidden), dev)
    lengths = int32_lengths(lengths, r, dev)
    dxf, dxb = (torch.empty((t_total, r, g), device=dev, dtype=torch.float32) for _ in range(2))
    # kernel 4 reads fp32 activations whatever the gates: it has no gate type
    plan = launch_plan("bilstm_train_bwd", r, hidden, None, dev, plan=backward_plan)
    launch(bilstm_train_bwd, "bilstm_train_bwd_launch", dev,
           acts.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(), ptr(lengths), cprev.data_ptr(),
           dfinal.data_ptr(), ptr(douts), dxf.data_ptr(), dxb.data_ptr(), t_total, r, hidden, *plan_args(plan))
    return dxf, dxb


bilstm_train_fwd.launches = 0
bilstm_train_bwd.launches = 0
