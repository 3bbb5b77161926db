"""The input projection of a BiLSTM: hand-written CUDA kernels and plain versions.

``input_proj`` is the plain projection ``x @ w_ih^T + b``, time-major, of
one direction. Five wrappers over three CUDA sources: three over
``csrc/input_proj.cu`` (bf16), the port's counterparts of the JAX
package's two probe kernels and the tanh pass that both run on fp32 x
before their product, one over ``csrc/input_proj_f32.cu`` (fp32) and one
over ``csrc/wgrad_f32.cu`` (fp32, the projection's weight gradient):

* ``input_proj_one`` replaces ``benchmarks/proj_probe.py::make_pallas_proj``:
  one direction of fp32 x, tanh applied, ``(T, R, 4H)`` bf16, optionally
  written time-reversed (``out[T-1-t]``).
* ``input_proj_both`` replaces ``benchmarks/proj_probe.py::make_pallas_both``:
  both directions from one pass over x, the forward in time order and the
  backward time-reversed, which is the layout kernel 1 reads
  (``ops/lstm_kernel.py``). ``fuse_tanh=True`` takes fp32 x and applies
  tanh first; ``fuse_tanh=False`` takes x already in bf16.
* ``tanh_to_bf16``: ``bf16(tanh(x))`` of fp32 x, once per element, into a
  bf16 scratch that the product reads. The TPU kernels apply tanh to each
  x tile inside the kernel (``benchmarks/proj_probe.py:79, 124``); a GEMM
  tiled over 4H would repeat that once per column tile.
* ``input_proj_f32`` (kernel 7) replaces no TPU kernel: both directions'
  fp32 gates ``x @ w_ih^T + b`` from one pass over fp32 x, in
  ``input_proj_both``'s layout, as 3xTF32 on the tensor cores; its plain
  version is the two ``input_proj`` calls it replaces, bit for bit. The
  appearance encoder takes it on the kernel path in fp32, in training
  (``ops/lstm_train.py``) and in eval (``ops/lstm.py::appearance_final_f32``);
  it counts the rows it projects in the tracer's ``proj.tc_f32_rows``.
* ``input_proj_f32_wgrad`` (kernel 8) replaces no TPU kernel: both
  directions' fp32 ``dW_ih = dxproj^T x`` from kernel 4's dgates as they
  lie, (T, R, 4H) in kernel time, as 3xTF32 on the tensor cores; its plain
  version is the two products the appearance op's backward ran before, bit
  for bit. That backward takes it in fp32 (``ops/lstm_train.py``), where
  its forward took kernel 7; it counts R*T in ``proj.tc_f32_wgrad_rows``.

The bf16 function, for x (R, T, D) and a direction's torch-layout ``w_ih``
(4H, D) and fp32 bias b (4H,): ``bf16(bf16(f(x[:, t])) @ bf16(w_ih)^T + b)``,
accumulated in fp32 and rounded once, after the bias. That is the
appearance encoder's projection under ``compute_dtype: bfloat16`` in the
JAX package (``models/encoders.py:102-103, 125-127``;
``ops/lstm_pallas_train.py:392-405``). A bf16 ``torch.matmul`` would round
its output before the bias, a second rounding. The wrappers round w_ih to
bf16 once per call.

``input_proj_both`` and ``input_proj_f32``, which the eval path runs, call
the torch custom ops ``dualvgr_torch::input_proj_both`` (the tanh pass
inside it) and ``dualvgr_torch::input_proj_f32``, so that ``torch.export``
keeps each as one node; ``input_proj_f32_wgrad`` is the custom op
``dualvgr_torch::input_proj_f32_wgrad`` likewise. On a CPU tensor each wrapper runs its
``*_reference``, the same function
step by step in PyTorch (tanh rounded to bf16, rounded operands upcast, an
fp32 product, the bias, one rounding); on a CUDA tensor it launches the
kernel through the shared launch (``ops/launch.py``) or raises. ``launches`` on each wrapper counts its own kernel's
launches: one per call of ``input_proj_one``, ``input_proj_both``,
``input_proj_f32`` (whose entry runs its weights' split pass and then the
product) and ``input_proj_f32_wgrad`` (x's split pass, then the product),
and ``tanh_to_bf16`` counts each tanh pass, the two projections' included.
They record nothing for autograd: the training path
(``ops/lstm_train.py``) calls kernels 6, 7 and 8 inside its
``torch.autograd.Function``. ``dim_limit`` and ``f32_dim_limit`` (kernels
7 and 8) say which widths the products cannot take; ``models/dualvgr.py::kernel_dim_limits``
refuses a model with such widths on the card before any forward.
"""

from __future__ import annotations

import torch

from dualvgr_tpu_torch.ops.launch import (
    OPS_NAMESPACE, call, check, check_aligned, dispatch, launch, refuse_autograd,
)
from dualvgr_tpu_torch.ops.precision import streamed_matmul
from dualvgr_tpu_torch.utils.trace import count


def input_proj(x, w_ih, b, *, reverse: bool = False, stream_dtype=None):
    """(B, T, D) -> (T, B, 4H) projection ``x @ w_ih^T + b``, w_ih (4H, D).

    One product batched over time, read from x through a transposed view (no
    copy of x) and written time-major; with ``reverse`` flipped in time, the
    layout the backward direction's recurrence takes. With ``stream_dtype``
    the product is streamed (``ops/precision.py``: rounded operands, fp32
    sum and output, exact-f32 gradients) and the fp32 bias added after it;
    the result stays fp32.
    """
    if stream_dtype is None:
        w = w_ih.t()
        out = torch.baddbmm(b, x.transpose(0, 1), w.expand(x.shape[1], *w.shape))
    else:
        out = streamed_matmul(x.transpose(0, 1), w_ih.t(), stream_dtype) + b
    return out.flip(0) if reverse else out


def tanh_to_bf16_reference(x):
    """Plain PyTorch version of the tanh pass: ``bf16(tanh(x))``, rounded to
    nearest even."""
    return torch.tanh(x).to(torch.bfloat16)


def _proj_reference(a16, w_ih, b, reverse):
    """(T, R, 4H) bf16 from bf16 x (R, T, D): upcast operands, fp32 product,
    the fp32 bias, one rounding; flipped in time with ``reverse``."""
    w16 = w_ih.to(torch.bfloat16).float()
    out = (torch.einsum("rtd,gd->trg", a16.float(), w16) + b).to(torch.bfloat16)
    return out.flip(0) if reverse else out


def input_proj_one_reference(x, w_ih, b, *, reverse: bool = False):
    """Plain PyTorch version of kernel 5 (fp32 x, tanh first)."""
    return _proj_reference(tanh_to_bf16_reference(x), w_ih, b, reverse)


def input_proj_both_reference(x, w_f, b_f, w_b, b_b, *, fuse_tanh: bool = True):
    """Plain PyTorch version of kernel 6: ``(xf, xb_rev)``."""
    a16 = tanh_to_bf16_reference(x) if fuse_tanh else x
    return _proj_reference(a16, w_f, b_f, False), _proj_reference(a16, w_b, b_b, True)


def input_proj_f32_reference(x, w_f, b_f, w_b, b_b):
    """Plain PyTorch version of kernel 7: ``(xf, xb_rev)``, the two fp32
    ``input_proj`` products it replaces."""
    return input_proj(x, w_f, b_f), input_proj(x, w_b, b_b, reverse=True)


def input_proj_f32_wgrad_reference(x, dxf, dxb):
    """Plain PyTorch version of kernel 8: ``(dw_f, dw_b)``, (4H, D) each,
    the two fp32 products it replaces: each direction's dgates (T, R, 4H),
    the backward's flipped back to the sequence's time, made row-major over
    (R*T) by a copy, transposed, times x (R*T, D)."""
    r, t, d = x.shape
    g = dxf.shape[-1]
    xs = x.reshape(r * t, d)
    dw_f = dxf.transpose(0, 1).reshape(r * t, g).t() @ xs
    dw_b = dxb.flip(0).transpose(0, 1).reshape(r * t, g).t() @ xs
    return dw_f, dw_b


def dim_limit(d, g):
    """Why the bf16 product cannot take x of width D = ``d`` into ``g`` = 4H
    gate columns, or None if it can."""
    if d % 8 or g % 8:
        return f"the bf16 projection kernel needs D % 8 == 0 and 4H % 8 == 0, got D={d}, 4H={g}"
    return None


def f32_dim_limit(d, g):
    """Why kernels 7 and 8 cannot take x of width D = ``d`` into ``g`` = 4H
    gate columns (16-byte rows and column groups), or None if they can."""
    if d <= 0 or g <= 0 or d % 4 or g % 4:
        return f"the fp32 projection kernel needs D % 4 == 0 and 4H % 4 == 0, got D={d}, 4H={g}"
    return None


def library_smem_bytes():
    """The dynamic shared memory of the product's CTA, the build's own."""
    return call("input_proj_smem_bytes", None)


def f32_library_smem_bytes():
    """The dynamic shared memory of kernel 7's CTA, the build's own."""
    return call("input_proj_f32_smem_bytes", None)


def f32_wgrad_library_smem_bytes():
    """The dynamic shared memory of kernel 8's CTA, the build's own."""
    return call("wgrad_f32_smem_bytes", None)


def _check_inputs(x, weights, biases, x_dtype, limit=dim_limit):
    """The kernels' contract on x (R, T, D) and each direction's w_ih (4H,
    D) and b (4H,), the widths within ``limit``; returns (R, T, D, 4H)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (R, T, D), got {tuple(x.shape)}")
    r, t, d = x.shape
    g = weights[0].shape[0]
    if (msg := limit(d, g)) is not None:
        raise ValueError(msg)
    check("x", x, (r, t, d), x.device, x_dtype)
    check_aligned("x", x)
    for k, (w, b) in enumerate(zip(weights, biases)):
        check(f"w_ih[{k}]", w, (g, d), x.device, torch.float32)
        check(f"b[{k}]", b, (g,), x.device, torch.float32)
    return r, t, d, g


def _launch(wrapper, x, weights, biases, reverse, fuse_tanh):
    """One product over ``len(weights)`` (1 or 2) directions, ``reverse`` a
    flag per direction, after the tanh pass with ``fuse_tanh``, counted in
    ``wrapper``; returns their outputs."""
    dev = x.device
    r, t, d, g = _check_inputs(x, weights, biases, torch.float32 if fuse_tanh else torch.bfloat16)
    if fuse_tanh:
        x = tanh_to_bf16(x)
    w16, bias = torch.cat(weights).to(torch.bfloat16), torch.cat(biases)
    outs = [torch.empty((t, r, g), device=dev, dtype=torch.bfloat16) for _ in weights]
    out_b = outs[1].data_ptr() if len(outs) > 1 else None
    launch(wrapper, "input_proj_launch", dev, x.data_ptr(), w16.data_ptr(), bias.data_ptr(), outs[0].data_ptr(),
           out_b, int(reverse[0]), int(reverse[-1]), r, t, d, g, len(weights))
    return outs


def tanh_to_bf16(x):
    """The tanh pass: x fp32, contiguous, last dimension % 8 == 0 -> bf16
    ``tanh(x)`` of the same shape."""
    refuse_autograd("tanh_to_bf16", x)
    return dispatch("tanh_to_bf16", x, tanh_to_bf16_reference, _tanh_cuda)(x)


def _tanh_cuda(x):
    if x.dim() == 0 or x.shape[-1] % 8:
        raise ValueError(f"the kernel needs a last dimension % 8 == 0, got shape {tuple(x.shape)}")
    check("x", x, x.shape, x.device, torch.float32)
    check_aligned("x", x)
    out = torch.empty(x.shape, device=x.device, dtype=torch.bfloat16)
    launch(tanh_to_bf16, "tanh_to_bf16_launch", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def input_proj_one(x, w_ih, b, *, reverse: bool = False):
    """Kernel 5: x (R, T, D) fp32, w_ih (4H, D), b (4H,) fp32 ->
    bf16 (T, R, 4H) of ``tanh(x) @ w_ih^T + b``, time-reversed with
    ``reverse``. On the card: the tanh pass, then the product."""
    refuse_autograd("input_proj_one", x, w_ih, b)
    return dispatch("input_proj_one", x, input_proj_one_reference, _one_cuda)(x, w_ih, b, reverse=reverse)


def _one_cuda(x, w_ih, b, *, reverse):
    (out,) = _launch(input_proj_one, x, (w_ih,), (b,), (reverse,), fuse_tanh=True)
    return out


def input_proj_both(x, w_f, b_f, w_b, b_b, *, fuse_tanh: bool = True):
    """Kernel 6: both directions' projections from one pass over x (R, T, D),
    fp32 with ``fuse_tanh`` (tanh applied first, by the tanh pass on the
    card), else bf16.

    Returns ``(xf, xb_rev)``, bf16 (T, R, 4H) each, ``xb_rev`` time-reversed.
    The work is the custom op ``dualvgr_torch::input_proj_both``, the tanh
    pass inside it, which ``torch.export`` keeps as one node of the graph.
    """
    refuse_autograd("input_proj_both", x, w_f, b_f, w_b, b_b)
    return dispatch("input_proj_both", x, _both_op, _both_op)(x, w_f, b_f, w_b, b_b, fuse_tanh)


@torch.library.custom_op(f"{OPS_NAMESPACE}::input_proj_both", mutates_args=(), device_types="cpu")
def _both_op(x: torch.Tensor, w_f: torch.Tensor, b_f: torch.Tensor, w_b: torch.Tensor, b_b: torch.Tensor,
             fuse_tanh: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version."""
    return input_proj_both_reference(x, w_f, b_f, w_b, b_b, fuse_tanh=fuse_tanh)


@_both_op.register_fake
def _(x, w_f, b_f, w_b, b_b, fuse_tanh):
    r, t, _ = x.shape
    return tuple(x.new_empty((t, r, w_f.shape[0]), dtype=torch.bfloat16) for _ in range(2))


@_both_op.register_kernel("cuda")
def _both_cuda(x, w_f, b_f, w_b, b_b, fuse_tanh):
    """The op on CUDA tensors: the tanh pass with ``fuse_tanh``, then one
    launch of the product in ``csrc/input_proj.cu``."""
    xf, xb = _launch(input_proj_both, x, (w_f, w_b), (b_f, b_b), (False, True), fuse_tanh)
    return xf, xb


def input_proj_f32(x, w_f, b_f, w_b, b_b):
    """Kernel 7: both directions' fp32 gates from one pass over fp32 x (R,
    T, D), w_* (4H, D), b_* (4H,) combined biases.

    Returns ``(xf, xb_rev)``, fp32 (T, R, 4H) each, ``xb_rev`` time-reversed.
    The work is the custom op ``dualvgr_torch::input_proj_f32``, which
    ``torch.export`` keeps as one node of the graph.
    """
    refuse_autograd("input_proj_f32", x, w_f, b_f, w_b, b_b)
    return dispatch("input_proj_f32", x, _f32_op, _f32_op)(x, w_f, b_f, w_b, b_b)


@torch.library.custom_op(f"{OPS_NAMESPACE}::input_proj_f32", mutates_args=(), device_types="cpu")
def _f32_op(x: torch.Tensor, w_f: torch.Tensor, b_f: torch.Tensor, w_b: torch.Tensor,
            b_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version."""
    return input_proj_f32_reference(x, w_f, b_f, w_b, b_b)


@_f32_op.register_fake
def _(x, w_f, b_f, w_b, b_b):
    r, t, _ = x.shape
    return tuple(x.new_empty((t, r, w_f.shape[0])) for _ in range(2))


@_f32_op.register_kernel("cuda")
def _f32_cuda(x, w_f, b_f, w_b, b_b):
    """The op on CUDA tensors: one launch of ``csrc/input_proj_f32.cu``,
    which splits the weights into their TF32 halves (into a scratch made
    here) and runs the product; counts R*T in ``proj.tc_f32_rows``."""
    dev = x.device
    r, t, d, g = _check_inputs(x, (w_f, w_b), (b_f, b_b), torch.float32, f32_dim_limit)
    for name, a in (("w_f", w_f), ("w_b", w_b), ("b_f", b_f), ("b_b", b_b)):
        check_aligned(name, a)
    split = torch.empty((2, 2 * g, d), device=dev, dtype=torch.float32)
    xf, xb = (torch.empty((t, r, g), device=dev, dtype=torch.float32) for _ in range(2))
    launch(input_proj_f32, "input_proj_f32_launch", dev, x.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
           b_f.data_ptr(), b_b.data_ptr(), split.data_ptr(), xf.data_ptr(), xb.data_ptr(), r, t, d, g)
    count("proj.tc_f32_rows", r * t)
    return xf, xb


def input_proj_f32_wgrad(x, dxf, dxb):
    """Kernel 8: both directions' fp32 input weight gradients from x (R, T,
    D) and their dgates dxf, dxb (T, R, 4H) in kernel time (``dxb``'s step
    t is the sequence's step T-1-t), read where they lie.

    Returns ``(dw_f, dw_b)``, fp32 (4H, D) each: ``sum over (t, r) of
    dxf[t, r]^T x[r, t]`` and of ``dxb[t, r]^T x[r, T-1-t]``. The work is the
    custom op ``dualvgr_torch::input_proj_f32_wgrad``.
    """
    refuse_autograd("input_proj_f32_wgrad", x, dxf, dxb)
    return dispatch("input_proj_f32_wgrad", x, _wgrad_op, _wgrad_op)(x, dxf, dxb)


@torch.library.custom_op(f"{OPS_NAMESPACE}::input_proj_f32_wgrad", mutates_args=(), device_types="cpu")
def _wgrad_op(x: torch.Tensor, dxf: torch.Tensor, dxb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version."""
    return input_proj_f32_wgrad_reference(x, dxf, dxb)


@_wgrad_op.register_fake
def _(x, dxf, dxb):
    return tuple(x.new_empty((dxf.shape[-1], x.shape[-1])) for _ in range(2))


@_wgrad_op.register_kernel("cuda")
def _wgrad_cuda(x, dxf, dxb):
    """The op on CUDA tensors: one launch of ``csrc/wgrad_f32.cu``, which
    splits x into its TF32 halves, K-major (D, T, R_pad), into a scratch
    made here, and runs the product; counts R*T in
    ``proj.tc_f32_wgrad_rows``."""
    dev = x.device
    if x.dim() != 3 or dxf.dim() != 3:
        raise ValueError(f"x must be (R, T, D) and the dgates (T, R, 4H), got {tuple(x.shape)}, {tuple(dxf.shape)}")
    r, t, d = x.shape
    g = dxf.shape[-1]
    if (msg := f32_dim_limit(d, g)) is not None:
        raise ValueError(msg)
    for name, a, shape in (("x", x, (r, t, d)), ("dxf", dxf, (t, r, g)), ("dxb", dxb, (t, r, g))):
        check(name, a, shape, dev, torch.float32)
        check_aligned(name, a)
    r_pad = -(-r // 4) * 4  # TMA's 16-byte strides
    split = torch.empty((2, d, t, r_pad), device=dev, dtype=torch.float32)
    dw_f, dw_b = (torch.empty((g, d), device=dev, dtype=torch.float32) for _ in range(2))
    launch(input_proj_f32_wgrad, "wgrad_f32_launch", dev, x.data_ptr(), dxf.data_ptr(), dxb.data_ptr(),
           split.data_ptr(), dw_f.data_ptr(), dw_b.data_ptr(), r, t, d, g, r_pad)
    count("proj.tc_f32_wgrad_rows", r * t)
    return dw_f, dw_b


tanh_to_bf16.launches = 0
input_proj_one.launches = 0
input_proj_both.launches = 0
input_proj_f32.launches = 0
input_proj_f32_wgrad.launches = 0
