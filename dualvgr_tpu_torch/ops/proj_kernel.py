"""The bf16 input projection of a BiLSTM: hand-written CUDA kernels and plain versions.

Two wrappers over one CUDA source (``csrc/input_proj.cu``), the port's
counterparts of the JAX package's two probe kernels:

* ``input_proj_one`` replaces ``benchmarks/proj_probe.py::make_pallas_proj``:
  one direction, tanh fused, ``(T, R, 4H)`` bf16, optionally written
  time-reversed (``out[T-1-t]``).
* ``input_proj_both`` replaces ``benchmarks/proj_probe.py::make_pallas_both``:
  both directions from one pass over x, the forward in time order and the
  backward time-reversed, which is the layout kernel 1 reads
  (``ops/lstm_kernel.py``). ``fuse_tanh=True`` takes fp32 x and applies
  tanh in the kernel; ``fuse_tanh=False`` takes x already in bf16.

The function, for x (R, T, D) and a direction's torch-layout ``w_ih``
(4H, D) and fp32 bias b (4H,): ``bf16(bf16(f(x[:, t])) @ bf16(w_ih)^T + b)``,
accumulated in fp32 and rounded once, after the bias. That is the
appearance encoder's projection under ``compute_dtype: bfloat16`` in the
JAX package (``models/encoders.py:102-103, 125-127``;
``ops/lstm_pallas_train.py:392-405``). A bf16 ``torch.matmul`` would round
its output before the bias, a second rounding. The wrappers round w_ih to
bf16 once per call.

On a CPU tensor each wrapper runs its ``*_reference``, the same function
step by step in PyTorch (rounded operands upcast, an fp32 product, the
bias, one rounding); on a CUDA tensor it launches the kernel or raises.
``launches`` on each wrapper counts its kernel's launches. Both record
nothing for autograd: the training path (``ops/lstm_train.py``) calls them
inside its ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.lstm_kernel import _check, refuse_autograd


def _proj_reference(a16, w_ih, b, reverse):
    """(T, R, 4H) bf16 from bf16 x (R, T, D): upcast operands, fp32 product,
    the fp32 bias, one rounding; flipped in time with ``reverse``."""
    w16 = w_ih.to(torch.bfloat16).float()
    out = (torch.einsum("rtd,gd->trg", a16.float(), w16) + b).to(torch.bfloat16)
    return out.flip(0) if reverse else out


def input_proj_one_reference(x, w_ih, b, *, reverse: bool = False):
    """Plain PyTorch version of kernel 5 (fp32 x, tanh fused)."""
    return _proj_reference(torch.tanh(x).to(torch.bfloat16), w_ih, b, reverse)


def input_proj_both_reference(x, w_f, b_f, w_b, b_b, *, fuse_tanh: bool = True):
    """Plain PyTorch version of kernel 6: ``(xf, xb_rev)``."""
    a16 = torch.tanh(x).to(torch.bfloat16) if fuse_tanh else x
    return _proj_reference(a16, w_f, b_f, False), _proj_reference(a16, w_b, b_b, True)


def _launch_fn():
    fn = _build.load("input_proj.cu").input_proj_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weights, biases, reverse, x_bf16):
    """One launch over ``len(weights)`` (1 or 2) directions, ``reverse`` a
    flag per direction; returns their outputs."""
    dev = x.device
    if x.dim() != 3:
        raise ValueError(f"x must be (R, T, D), got {tuple(x.shape)}")
    r, t, d = x.shape
    g = weights[0].shape[0]
    if d % 8 or g % 8:
        raise ValueError(f"the kernel needs D % 8 == 0 and 4H % 8 == 0, got D={d}, 4H={g}")
    _check("x", x, (r, t, d), dev, torch.bfloat16 if x_bf16 else torch.float32)
    for k, (w, b) in enumerate(zip(weights, biases)):
        _check(f"w_ih[{k}]", w, (g, d), dev, torch.float32)
        _check(f"b[{k}]", b, (g,), dev, torch.float32)
    w16, bias = torch.cat(weights).to(torch.bfloat16), torch.cat(biases)
    outs = [torch.empty((t, r, g), device=dev, dtype=torch.bfloat16) for _ in weights]
    out_b = outs[1].data_ptr() if len(outs) > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn()(
            x.data_ptr(), int(x_bf16), w16.data_ptr(), bias.data_ptr(), outs[0].data_ptr(), out_b,
            int(reverse[0]), int(reverse[-1]), r, t, d, g, len(weights), stream,
        )
    if err != 0:
        raise RuntimeError(f"input_proj launch failed: cudaError {err}")
    return outs


def input_proj_one(x, w_ih, b, *, reverse: bool = False):
    """Kernel 5: x (R, T, D) fp32, w_ih (4H, D), b (4H,) fp32 ->
    bf16 (T, R, 4H) of ``tanh(x) @ w_ih^T + b``, time-reversed with
    ``reverse``."""
    refuse_autograd("input_proj_one", x, w_ih, b)
    if x.device.type == "cpu":
        return input_proj_one_reference(x, w_ih, b, reverse=reverse)
    if x.device.type != "cuda":
        raise ValueError(f"input_proj_one runs on CPU or CUDA, not {x.device}")
    (out,) = _launch(x, (w_ih,), (b,), (reverse,), x_bf16=False)
    input_proj_one.launches += 1
    return out


def input_proj_both(x, w_f, b_f, w_b, b_b, *, fuse_tanh: bool = True):
    """Kernel 6: both directions' projections from one pass over x (R, T, D),
    fp32 with ``fuse_tanh`` (tanh applied in the kernel), else bf16.

    Returns ``(xf, xb_rev)``, bf16 (T, R, 4H) each, ``xb_rev`` time-reversed.
    """
    refuse_autograd("input_proj_both", x, w_f, b_f, w_b, b_b)
    if x.device.type == "cpu":
        return input_proj_both_reference(x, w_f, b_f, w_b, b_b, fuse_tanh=fuse_tanh)
    if x.device.type != "cuda":
        raise ValueError(f"input_proj_both runs on CPU or CUDA, not {x.device}")
    xf, xb = _launch(x, (w_f, w_b), (b_f, b_b), (False, True), x_bf16=not fuse_tanh)
    input_proj_both.launches += 1
    return xf, xb


input_proj_one.launches = 0
input_proj_both.launches = 0
