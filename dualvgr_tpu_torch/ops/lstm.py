"""Masked bidirectional LSTM: the input projection and the plain BiLSTM.

Reference semantics (model/Preprocessing.py): packed cuDNN sequences,
matched with masks on right-padded input and a zero initial state. The
forward direction carries its state through padding (its final state is
the state at len-1); the backward direction stays at zero until it enters
its valid region; per-step outputs are zero at padding. Gate order is
torch's (i, f, g, o), and each direction has torch's two bias vectors,
summed into the projection.

The input projection ``x @ w_ih + (b_ih + b_hh)`` for all time steps is one
batched product per direction left to ``torch.baddbmm``, as the JAX package
leaves it to XLA outside any kernel; only the recurrence is a kernel
(``dualvgr_tpu_torch.ops.lstm_kernel``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dualvgr_tpu_torch.ops.lstm_kernel import bilstm_recurrence, bilstm_recurrence_reference


class LSTMParams(NamedTuple):
    """One direction's parameters in torch's layout: w_ih (4H, D),
    w_hh (4H, H), b_ih and b_hh (4H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor


def time_major_input_proj(x, params: LSTMParams, *, reverse: bool = False):
    """(B, T, D) -> (T, B, 4H) projection ``x @ w_ih^T + b_ih + b_hh``.

    One product batched over time, read from x through a transposed view
    (no copy of x) and written time-major. With ``reverse`` the result is
    flipped in time, the layout the backward direction's recurrence takes.
    """
    w = params.w_ih.t()
    out = torch.baddbmm(params.b_ih + params.b_hh, x.transpose(0, 1), w.expand(x.shape[1], *w.shape))
    return out.flip(0) if reverse else out


def bilstm(
    fwd: LSTMParams, bwd: LSTMParams, x, lengths=None, *,
    with_outputs: bool = True, use_kernel: bool = False,
):
    """Bidirectional masked LSTM over x (B, T, D).

    Returns (outputs (B, T, 2H) with [fwd, bwd] features, or None without
    ``with_outputs``; final (B, 2H) = [fwd at len-1, bwd at t=0]).
    ``use_kernel`` routes the recurrence through ``bilstm_recurrence``
    (the CUDA kernel on a CUDA tensor), else through its plain version.
    """
    xf = time_major_input_proj(x, fwd)
    xb = time_major_input_proj(x, bwd, reverse=True)
    recurrence = bilstm_recurrence if use_kernel else bilstm_recurrence_reference
    res = recurrence(
        xf, xb, fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous(), lengths,
        with_outputs=with_outputs,
    )
    if with_outputs:
        final, outs = res
        return outs, final
    return None, res
