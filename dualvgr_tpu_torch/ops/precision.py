"""Mixed-precision matmul streaming (``compute_dtype: bfloat16``).

The port's copy of ``dualvgr_tpu/ops/precision.py``. Parameters, biases,
accumulators, softmaxes, norms and recurrences stay fp32; only the operands
of the streamed matmuls are rounded to the stream dtype (bf16), with fp32
accumulation and an fp32 output.

The gradients are exact-f32: the backward of a streamed product rounds the
operands it multiplies (the saved bf16 operands and the cotangent ``g``) to
bf16 and forms both cotangents as bf16-operand products with fp32
accumulation and fp32 output, with no rounding of their result. Plain
autograd through the casts would round each cotangent to bf16 on its way
back.

The product of two rounded operands with an fp32 output: on a CUDA tensor
``torch.mm(a, b, out_dtype=torch.float32)``, the tensor cores' bf16 x bf16 ->
fp32 path; on the CPU (no such kernel) the rounded operands are upcast,
which gives the same numbers up to the order of the sums, since a product
of two bf16 values is exact in fp32. A bf16 ``torch.matmul`` would round
its output to bf16, and ``torch.autocast`` rounds in other places: neither
is used.

The knob is threaded explicitly: each streamed module holds
``stream_dtype`` (None for fp32), set from the model's ``compute_dtype``
(``models/dualvgr.py``). QueryAttn and QueryPunish are not streamed (their
products are a small share of the work, and QueryAttn's output feeds an
l2-normalize and a masked softmax that amplify operand rounding).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

_STREAM_DTYPES = {"bfloat16": torch.bfloat16}


def stream_dtype_of(compute_dtype: str | None) -> torch.dtype | None:
    """Map a ``compute_dtype`` name to the operand stream dtype (None = fp32)."""
    if compute_dtype is None or compute_dtype == "float32":
        return None
    if compute_dtype not in _STREAM_DTYPES:
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    return _STREAM_DTYPES[compute_dtype]


def mm_f32(a, b):
    """(M, K) @ (K, N) of two stream-dtype operands, fp32 accumulation and
    output (see the module docstring for the two devices)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _contract(spec: str, a, b):
    """einsum over already-rounded operands, upcast: fp32 accumulation and
    output on either device."""
    return torch.einsum(spec, a.float(), b.float())


@functools.lru_cache(maxsize=None)
def _transpose_specs(spec: str) -> tuple[str, str]:
    """Cotangent specs of a 2-operand ``spec`` "a,b->o": ("o,b->a", "a,o->b").

    Valid when no operand repeats an index and every index of each operand
    appears in the output or the other operand; a spec that breaks this
    raises rather than be differentiated wrongly.
    """
    ins, out = spec.split("->")
    a, b = ins.split(",")
    for op, other in ((a, b), (b, a)):
        if len(set(op)) != len(op):
            raise ValueError(f"repeated index in {spec!r}")
        if not set(op) <= set(out) | set(other):
            raise ValueError(f"summed-only index in {spec!r}")
    return f"{out},{b}->{a}", f"{a},{out}->{b}"


class _StreamedMatmul(torch.autograd.Function):
    """x (..., K) @ w (K, N) with stream-dtype operands and exact-f32 cotangents."""

    @staticmethod
    def forward(ctx, x, w, sd):
        xs = x.to(sd).reshape(-1, x.shape[-1])
        ws = w.to(sd)
        ctx.save_for_backward(xs, ws)
        ctx.shapes = (x.shape, x.dtype, w.dtype)
        return mm_f32(xs, ws).view(*x.shape[:-1], w.shape[-1])

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xs, ws = ctx.saved_tensors
        x_shape, x_dtype, w_dtype = ctx.shapes
        gs = g.reshape(-1, g.shape[-1]).to(xs.dtype)
        dx = mm_f32(gs, ws.t()).view(x_shape).to(x_dtype) if ctx.needs_input_grad[0] else None
        dw = mm_f32(xs.t(), gs).to(w_dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class _StreamedEinsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, x, w, sd):
        xs, ws = x.to(sd), w.to(sd)
        ctx.save_for_backward(xs, ws)
        ctx.spec, ctx.dtypes = spec, (x.dtype, w.dtype)
        return _contract(spec, xs, ws)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xs, ws = ctx.saved_tensors
        spec_dx, spec_dw = _transpose_specs(ctx.spec)
        gs = g.to(xs.dtype)
        dx = _contract(spec_dx, gs, ws).to(ctx.dtypes[0]) if ctx.needs_input_grad[1] else None
        dw = _contract(spec_dw, xs, gs).to(ctx.dtypes[1]) if ctx.needs_input_grad[2] else None
        return None, dx, dw, None


def streamed_matmul(x, w, stream_dtype: torch.dtype | None):
    """``x @ w`` for x (..., D), w (D, N). With ``stream_dtype`` the operands
    are rounded to it, the sum and the output are fp32 and the gradients
    exact-f32; without it, a plain fp32 product."""
    if stream_dtype is None:
        return x @ w
    return _StreamedMatmul.apply(x, w, stream_dtype)


def streamed_einsum(spec: str, x, w, stream_dtype: torch.dtype | None):
    """``torch.einsum(spec, x, w)`` with the same policy as
    ``streamed_matmul``, for contractions a plain ``x @ w`` cannot express.
    The contraction runs on upcast operands on either device."""
    if stream_dtype is None:
        return torch.einsum(spec, x, w)
    _transpose_specs(spec)  # refuse a spec whose gradient would be wrong
    return _StreamedEinsum.apply(spec, x, w, stream_dtype)


class _StreamRoundtrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sd):
        return x.to(sd).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def stream_roundtrip(x, stream_dtype: torch.dtype):
    """``x -> stream_dtype -> x.dtype`` with an identity gradient: the rounding
    the kernels apply when they read gates in the stream dtype, so the plain
    path rounds where they do, while the cotangent passes unrounded."""
    return _StreamRoundtrip.apply(x, stream_dtype)


class SLinear(nn.Linear):
    """``nn.Linear`` whose product honours ``stream_dtype`` (the counterpart
    of the JAX package's ``SDense``): the same parameters and state_dict keys,
    and with ``stream_dtype=None`` the same numbers. The bias is added in
    fp32 after the product."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.stream_dtype: torch.dtype | None = None

    def forward(self, x):
        if self.stream_dtype is None:
            return F.linear(x, self.weight, self.bias)
        y = streamed_matmul(x, self.weight.t(), self.stream_dtype)
        return y if self.bias is None else y + self.bias
