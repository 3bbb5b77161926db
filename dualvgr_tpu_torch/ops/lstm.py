"""Masked bidirectional LSTM: the input projection and the plain BiLSTM.

Reference semantics (model/Preprocessing.py): packed cuDNN sequences,
matched with masks on right-padded input and a zero initial state. The
forward direction carries its state through padding (its final state is
the state at len-1); the backward direction stays at zero until it enters
its valid region; per-step outputs are zero at padding. Gate order is
torch's (i, f, g, o), and each direction has torch's two bias vectors,
summed into the projection.

The input projection ``x @ w_ih + (b_ih + b_hh)`` for all time steps is one
batched product per direction left to ``torch.baddbmm``
(``ops/proj_kernel.py::input_proj``), as the JAX package leaves it to XLA
outside any kernel; the recurrence is a kernel
(``dualvgr_tpu_torch.ops.lstm_kernel`` for eval, the trainable pair of
``dualvgr_tpu_torch.ops.lstm_train`` for training). The appearance
encoder's projection is a kernel too on the kernel path: in fp32 one
launch of kernel 7 gives both directions' gates (``appearance_final_f32``
in eval, ``ops/lstm_train.py`` in training).

Under a stream dtype (``compute_dtype: bfloat16``, the JAX package's
``ops/lstm.py:82-185`` and ``models/encoders.py:78-137``) the projection is
streamed (``ops/precision.py``), and the gates are rounded to bf16 where
the kernels read them in bf16: the plain routing and the trainable kernels
take them through ``stream_roundtrip`` (rounded, fp32, identity gradient);
kernel 1 takes them in bf16 and gives its outputs in bf16, upcast here.
The appearance encoder's eval kernel routing (``appearance_final_bf16``)
computes both directions' bf16 gates in one launch of kernel 6, tanh fused.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dualvgr_tpu_torch.ops.lstm_kernel import _lstm_step, bilstm_recurrence, bilstm_recurrence_reference
from dualvgr_tpu_torch.ops.lstm_train import appearance_bilstm_train, bilstm_trainable
from dualvgr_tpu_torch.ops.precision import stream_roundtrip
from dualvgr_tpu_torch.ops.proj_kernel import input_proj, input_proj_both, input_proj_f32


class LSTMParams(NamedTuple):
    """One direction's parameters in torch's layout: w_ih (4H, D),
    w_hh (4H, H), b_ih and b_hh (4H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor


def time_major_input_proj(x, params: LSTMParams, *, reverse: bool = False, stream_dtype=None):
    """(B, T, D) -> (T, B, 4H) projection ``x @ w_ih^T + b_ih + b_hh``
    (``ops/proj_kernel.py::input_proj``); with ``reverse`` flipped in time,
    with ``stream_dtype`` streamed. fp32 out."""
    return input_proj(x, params.w_ih, params.b_ih + params.b_hh, reverse=reverse, stream_dtype=stream_dtype)


def appearance_final_bf16(fwd: LSTMParams, bwd: LSTMParams, x):
    """Final states (R, 2H), fp32, of the BiLSTM over ``tanh(x)``, x (R, T, D)
    fp32 full-length: the eval kernel routing under bf16 streaming. One
    launch of kernel 6 with tanh fused gives both directions' bf16 gates
    from the raw x; kernel 1 reads them and gives bf16 final states,
    upcast. Records nothing for autograd (eval only)."""
    xf, xb = input_proj_both(x, fwd.w_ih, fwd.b_ih + fwd.b_hh, bwd.w_ih, bwd.b_ih + bwd.b_hh, fuse_tanh=True)
    final = bilstm_recurrence(xf, xb, fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous())
    return final.float()


def appearance_final_f32(fwd: LSTMParams, bwd: LSTMParams, x):
    """Final states (R, 2H), fp32, of the BiLSTM over fp32 x (R, T, D),
    full-length: the eval kernel routing in fp32. One launch of kernel 7
    gives both directions' fp32 gates, which kernel 1 reads. Records
    nothing for autograd (eval only)."""
    xf, xb = input_proj_f32(x, fwd.w_ih, fwd.b_ih + fwd.b_hh, bwd.w_ih, bwd.b_ih + bwd.b_hh)
    return bilstm_recurrence(xf, xb, fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous())


def bilstm(
    fwd: LSTMParams, bwd: LSTMParams, x, lengths=None, *,
    with_outputs: bool = True, use_kernel: bool = False, train: bool = False,
    drop_input_grad: bool = False, stream_dtype=None, proj=None,
):
    """Bidirectional masked LSTM over x (B, T, D).

    Returns (outputs (B, T, 2H) with [fwd, bwd] features, or None without
    ``with_outputs``; final (B, 2H) = [fwd at len-1, bwd at t=0]).
    ``use_kernel`` routes the recurrence through the port's kernels (on a
    CUDA tensor), else through the plain recurrence, which autograd
    differentiates. With ``use_kernel``: in eval, ``bilstm_recurrence``; with
    ``train``, the trainable pair, the counterpart of the JAX BiLSTM's
    ``fused="trainable"/"trainable_final"`` modes (``bilstm_trainable``) or,
    with ``drop_input_grad``, of ``"final_trainable"``
    (``appearance_bilstm_train``: full-length, final-only, no gradient for
    x, so only for an x with nothing trainable upstream). ``stream_dtype``
    (None or bf16) streams the projection and rounds the gates (module
    docstring); the outputs are fp32 in every routing. ``proj`` replaces
    ``time_major_input_proj`` on the plain and trainable routings (tensor
    parallelism's column-parallel projection, ``parallel/tp.py``).
    """
    sd = stream_dtype
    w_hh_f, w_hh_b = fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous()
    if use_kernel and train and drop_input_grad:
        if lengths is not None or with_outputs:
            raise ValueError("drop_input_grad takes full-length sequences and gives the final state only")
        final = appearance_bilstm_train(
            x, fwd.w_ih, fwd.b_ih + fwd.b_hh, w_hh_f, bwd.w_ih, bwd.b_ih + bwd.b_hh, w_hh_b,
            stream_dtype=sd,
        )
        return None, final
    proj = proj or time_major_input_proj
    xf = proj(x, fwd, stream_dtype=sd)
    xb = proj(x, bwd, reverse=True, stream_dtype=sd)
    if sd is not None:
        if use_kernel and not train:  # kernel 1 reads bf16 gates
            xf, xb = xf.to(sd), xb.to(sd)
        else:
            xf, xb = stream_roundtrip(xf, sd), stream_roundtrip(xb, sd)
    if use_kernel and train:
        final, outs = bilstm_trainable(xf, xb, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs)
        return outs, final
    recurrence = bilstm_recurrence if use_kernel else bilstm_recurrence_reference
    res = recurrence(xf, xb, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs)
    final, outs = res if with_outputs else (res, None)
    # kernel 1 gives its outputs in the gates' dtype
    return (outs.float() if with_outputs else None), final.float()


def lstm_unroll(params: LSTMParams, x, lengths=None):
    """Single-direction masked LSTM over x (B, T, D), plain PyTorch (the
    JAX package's ``ops/lstm.py::lstm_unroll``, forward in time): the state
    carried through padding, the outputs zero there. Returns (outputs
    (B, T, H), final h (B, H))."""
    xp = time_major_input_proj(x, params)  # (T, B, 4H)
    t_total, b, g = xp.shape
    h = c = xp.new_zeros((b, g // 4))
    w_hh = params.w_hh.t()
    outs = []
    for t in range(t_total):
        h_new, c_new, _ = _lstm_step(xp[t] + h @ w_hh, c)
        if lengths is None:
            h, c = h_new, c_new
            outs.append(h)
        else:
            m = (t < lengths.to(device=x.device).view(b, 1))
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
            outs.append(h * m)
    return torch.stack(outs, dim=1), h
