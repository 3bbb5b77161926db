"""The bf16 input projection of a BiLSTM: hand-written CUDA kernels and plain versions.

Three wrappers over one CUDA source (``csrc/input_proj.cu``): two are the
port's counterparts of the JAX package's two probe kernels, the third is
the tanh pass that both run on fp32 x before their product:

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

The function, for x (R, T, D) and a direction's torch-layout ``w_ih``
(4H, D) and fp32 bias b (4H,): ``bf16(bf16(f(x[:, t])) @ bf16(w_ih)^T + b)``,
accumulated in fp32 and rounded once, after the bias. That is the
appearance encoder's projection under ``compute_dtype: bfloat16`` in the
JAX package (``models/encoders.py:102-103, 125-127``;
``ops/lstm_pallas_train.py:392-405``). A bf16 ``torch.matmul`` would round
its output before the bias, a second rounding. The wrappers round w_ih to
bf16 once per call.

``input_proj_both``, which the eval path runs, calls the torch custom op
``dualvgr_torch::input_proj_both`` (the tanh pass inside it), so that
``torch.export`` keeps it as one node. On a CPU tensor each wrapper runs
its ``*_reference``, the same function
step by step in PyTorch (tanh rounded to bf16, rounded operands upcast, an
fp32 product, the bias, one rounding); on a CUDA tensor it launches the
kernel through the shared launch (``ops/launch.py``) or raises. ``launches`` on each wrapper counts its own kernel's
launches: one per call of ``input_proj_one`` and ``input_proj_both``, and
``tanh_to_bf16`` counts each tanh pass, the two projections' included.
They record nothing for autograd: the training path
(``ops/lstm_train.py``) calls kernel 6 inside its
``torch.autograd.Function``. ``dim_limit`` says which widths the product
cannot take.
"""

from __future__ import annotations

import torch

from dualvgr_tpu_torch.ops.launch import (
    OPS_NAMESPACE, call, check, check_aligned, dispatch, launch, refuse_autograd,
)


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


def dim_limit(d, g):
    """Why the product cannot take x of width D = ``d`` into ``g`` = 4H
    gate columns, or None if it can."""
    if d % 8 or g % 8:
        return f"the bf16 projection kernel needs D % 8 == 0 and 4H % 8 == 0, got D={d}, 4H={g}"
    return None


def library_smem_bytes():
    """The dynamic shared memory of the product's CTA, the build's own."""
    return call("input_proj_smem_bytes", None)


def _check_inputs(x, weights, biases, x_dtype):
    """The kernels' contract on x (R, T, D) and each direction's w_ih (4H,
    D) and b (4H,); returns (R, T, D, 4H)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (R, T, D), got {tuple(x.shape)}")
    r, t, d = x.shape
    g = weights[0].shape[0]
    if (msg := dim_limit(d, g)) is not None:
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


tanh_to_bf16.launches = 0
input_proj_one.launches = 0
input_proj_both.launches = 0
