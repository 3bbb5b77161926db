"""Trainable BiLSTM: autograd Functions around kernels 3 and 4.

The autograd half of ``dualvgr_tpu/ops/lstm_pallas_train.py``. Both
Functions run the training forward (``bilstm_train_fwd``, which keeps the
pre-step states and the gate activations) and, in the backward, the
reverse-time kernel (``bilstm_train_bwd``), which gives the dgates from the
activations and c_{t-1}. They save the activations, fp32 (2, T, R, 4H), in
place of the gate inputs, which are then freed after the forward. The
recurrent weights' gradient ``dW_hh = sum_t h_{t-1}^T dgates`` of both
directions is one launch of kernel 9 (``ops/whh_grad_kernel.py::whh_grad_f32``,
3xTF32 on the tensor cores) on kernel 3's hprev and kernel 4's dgates as
they lie, where the JAX package leaves it to XLA
(``lstm_pallas_train.py:274-277``); on CPU tensors its plain version, one
fp32 product per direction over ``(T*R, H)^T @ (T*R, 4H)``.

* ``BiLSTMTrainable`` (``bilstm_trainable``), the twin of
  ``bilstm_trainable``: the full VJP over the gate inputs and W_hh. The input
  projection stays outside (``ops/lstm.py::time_major_input_proj`` on
  ``ops/proj_kernel.py::input_proj``), so
  autograd carries dxproj on to W_ih, the biases and the word embeddings.
* ``AppearanceBiLSTMTrain`` (``appearance_bilstm_train``), the twin of
  ``appearance_bilstm_train``: the input projection sits inside, and the
  backward computes ``dW_ih = dxproj^T x`` and ``db = sum dxproj`` itself.
  It gives x no gradient by design, which is sound only when nothing
  trainable sits upstream of x (the appearance encoder's x is
  tanh(dropout(raw features))); the JAX op stop_gradient()s x, and this one
  refuses an x that requires grad. In fp32 the forward projection is one
  launch of kernel 7 (``ops/proj_kernel.py::input_proj_f32``, 3xTF32 on
  the tensor cores; on a CPU tensor its plain version, the two
  ``input_proj`` products). Under a stream dtype
  (``lstm_pallas_train.py:376-475``) the forward projection is one launch
  of kernel 6 (``ops/proj_kernel.py::input_proj_both``, no tanh) on the
  bf16-rounded x, whose bf16 gates kernel 3 reads; x is saved in bf16 for
  the backward, which gives dW_ih as a bf16-operand product with fp32
  output and db from the fp32 dgates. In fp32 the backward's dW_ih is one
  launch of kernel 8 (``ops/proj_kernel.py::input_proj_f32_wgrad``, 3xTF32
  on the tensor cores, both directions from kernel 4's dgates as they lie;
  on a CPU tensor its plain version, the two fp32 products), so the fp32
  forward and backward take the tensor cores together.

Weights come in as (H, 4H) recurrent matrices (``weight_hh.t().contiguous()``)
and, for the appearance op, torch-layout (4H, D) input matrices and one
combined bias ``b_ih + b_hh`` formed outside, so both torch-style bias
vectors get the same gradient.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from dualvgr_tpu_torch.ops.lstm_train_kernel import bilstm_train_bwd, bilstm_train_fwd
from dualvgr_tpu_torch.ops.precision import mm_f32
from dualvgr_tpu_torch.ops.proj_kernel import input_proj_both, input_proj_f32, input_proj_f32_wgrad
from dualvgr_tpu_torch.ops.whh_grad_kernel import whh_grad_f32


def recurrent_weight_grads(hprev, dxf, dxb):
    """``dW_hh = sum_t h_{t-1}^T dgates`` per direction, (H, 4H) each, from the
    (T, R, 2H) residuals and the (T, R, 4H) dgates in kernel time: both
    directions in one launch of kernel 9 on CUDA tensors, the two plain
    products on CPU tensors."""
    return whh_grad_f32(hprev, dxf, dxb)


class BiLSTMTrainable(torch.autograd.Function):
    """Differentiable BiLSTM recurrence with optional masking and outputs."""

    @staticmethod
    def forward(ctx, xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs):
        final, outs, hprev, cprev, acts = bilstm_train_fwd(
            xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs
        )
        ctx.save_for_backward(acts, w_hh_f, w_hh_b, lengths, hprev, cprev)
        ctx.with_outputs = with_outputs
        return (final, outs) if with_outputs else final

    @staticmethod
    @once_differentiable
    def backward(ctx, dfinal, douts=None):
        acts, w_hh_f, w_hh_b, lengths, hprev, cprev = ctx.saved_tensors
        dxf, dxb = bilstm_train_bwd(
            acts, w_hh_f, w_hh_b, lengths, cprev, dfinal.contiguous(),
            douts.contiguous() if ctx.with_outputs else None,
        )
        dwf, dwb = recurrent_weight_grads(hprev, dxf, dxb)
        return dxf, dxb, dwf, dwb, None, None


def bilstm_trainable(xf, xb_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = True):
    """Differentiable fused BiLSTM: xf/xb_rev (T, R, 4H) gate inputs (xb_rev
    time-reversed), w_hh_* (H, 4H), optional (R,) lengths.

    Returns ``(final (R, 2H), outs)``: outs (R, T, 2H), zero at padding, the
    backward half in original time order, or None without ``with_outputs``.
    """
    res = BiLSTMTrainable.apply(xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs)
    return res if with_outputs else (res, None)


class AppearanceBiLSTMTrain(torch.autograd.Function):
    """Input projection + final-state recurrence over full-length sequences;
    no gradient for x (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w_ih_f, b_f, w_hh_f, w_ih_b, b_b, w_hh_b, stream_dtype):
        if stream_dtype is None:
            # both directions' fp32 gates from one launch of kernel 7
            xf, xb = input_proj_f32(x.contiguous(), w_ih_f, b_f, w_ih_b, b_b)
        else:
            # both directions' gates from one launch of kernel 6 on the
            # rounded x, rounded once after the fp32 bias (the JAX _proj)
            x = x.to(stream_dtype)
            xf, xb = input_proj_both(x, w_ih_f, b_f, w_ih_b, b_b, fuse_tanh=False)
        final, _, hprev, cprev, acts = bilstm_train_fwd(xf, xb, w_hh_f, w_hh_b)
        ctx.save_for_backward(x, acts, w_hh_f, w_hh_b, hprev, cprev)
        return final

    @staticmethod
    @once_differentiable
    def backward(ctx, dfinal):
        x, acts, w_hh_f, w_hh_b, hprev, cprev = ctx.saved_tensors
        dxf, dxb = bilstm_train_bwd(acts, w_hh_f, w_hh_b, None, cprev, dfinal.contiguous())
        dwhf, dwhb = recurrent_weight_grads(hprev, dxf, dxb)
        # dW_ih = sum over (t, r) of dxproj^T x, the backward direction's
        # dgates read back in original time. In fp32 both directions are
        # one launch of kernel 8. Under a stream dtype x is saved rounded
        # and the dgates are rounded as operands (the JAX _sd_einsum), one
        # product per direction with an fp32 output.
        if x.dtype == torch.float32:
            dwih_f, dwih_b = input_proj_f32_wgrad(x.contiguous(), dxf, dxb)
        else:
            r, t, d = x.shape
            xs = x.reshape(r * t, d)
            g = dxf.shape[-1]
            dwih_f = mm_f32(dxf.to(x.dtype).transpose(0, 1).reshape(r * t, g).t(), xs)
            dwih_b = mm_f32(dxb.to(x.dtype).flip(0).transpose(0, 1).reshape(r * t, g).t(), xs)
        return None, dwih_f, dxf.sum((0, 1)), dwhf, dwih_b, dxb.sum((0, 1)), dwhb, None


def appearance_bilstm_train(x, w_ih_f, b_f, w_hh_f, w_ih_b, b_b, w_hh_b, *, stream_dtype=None):
    """Differentiable appearance-encoder BiLSTM layer: x (R, T, D) ->
    final (R, 2H). Raises if x requires grad: this op drops dL/dx by design.
    w_ih_* (4H, D), b_* (4H,) combined, w_hh_* (H, 4H); ``stream_dtype``
    (None or bf16) as in the module docstring."""
    if x.requires_grad:
        raise RuntimeError(
            "appearance_bilstm_train gives x no gradient by design and x requires grad: "
            "use bilstm_trainable, whose VJP covers the input"
        )
    return AppearanceBiLSTMTrain.apply(x, w_ih_f, b_f, w_hh_f, w_ih_b, b_b, w_hh_b, stream_dtype)
