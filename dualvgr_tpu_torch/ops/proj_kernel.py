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

On a CPU tensor each wrapper runs its ``*_reference``, the same function
step by step in PyTorch (tanh rounded to bf16, rounded operands upcast, an
fp32 product, the bias, one rounding); on a CUDA tensor it launches the
kernel or raises. ``launches`` on each wrapper counts its own kernel's
launches: one per call of ``input_proj_one`` and ``input_proj_both``, and
``tanh_to_bf16`` counts each tanh pass, the two projections' included.
They record nothing for autograd: the training path
(``ops/lstm_train.py``) calls kernel 6 inside its
``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes

import torch

from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.lstm_kernel import _check, refuse_autograd


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


def _lib():
    lib = _build.load("input_proj.cu")
    lib.input_proj_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.input_proj_launch.restype = ctypes.c_int
    lib.tanh_to_bf16_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.tanh_to_bf16_launch.restype = ctypes.c_int
    return lib


def _check_aligned(name, t):
    """TMA and the 16-byte vector accesses need 16-byte aligned data."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte aligned address (storage offset {t.storage_offset()})")


def _check_inputs(x, weights, biases, x_dtype):
    """The kernels' contract on x (R, T, D) and each direction's w_ih (4H,
    D) and b (4H,); returns (R, T, D, 4H)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (R, T, D), got {tuple(x.shape)}")
    r, t, d = x.shape
    g = weights[0].shape[0]
    if d % 8 or g % 8:
        raise ValueError(f"the kernel needs D % 8 == 0 and 4H % 8 == 0, got D={d}, 4H={g}")
    _check("x", x, (r, t, d), x.device, x_dtype)
    _check_aligned("x", x)
    for k, (w, b) in enumerate(zip(weights, biases)):
        _check(f"w_ih[{k}]", w, (g, d), x.device, torch.float32)
        _check(f"b[{k}]", b, (g,), x.device, torch.float32)
    return r, t, d, g


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(x, weights, biases, reverse, fuse_tanh):
    """One product over ``len(weights)`` (1 or 2) directions, ``reverse`` a
    flag per direction, after the tanh pass with ``fuse_tanh``; returns
    their outputs."""
    dev = x.device
    r, t, d, g = _check_inputs(x, weights, biases, torch.float32 if fuse_tanh else torch.bfloat16)
    if fuse_tanh:
        x = tanh_to_bf16(x)
    w16, bias = torch.cat(weights).to(torch.bfloat16), torch.cat(biases)
    outs = [torch.empty((t, r, g), device=dev, dtype=torch.bfloat16) for _ in weights]
    out_b = outs[1].data_ptr() if len(outs) > 1 else None
    with torch.cuda.device(dev):
        err = _lib().input_proj_launch(
            x.data_ptr(), w16.data_ptr(), bias.data_ptr(), outs[0].data_ptr(), out_b,
            int(reverse[0]), int(reverse[-1]), r, t, d, g, len(weights), _stream(dev),
        )
    if err != 0:
        raise RuntimeError(f"input_proj launch failed: cudaError {err}")
    return outs


def tanh_to_bf16(x):
    """The tanh pass: x fp32, contiguous, last dimension % 8 == 0 -> bf16
    ``tanh(x)`` of the same shape."""
    refuse_autograd("tanh_to_bf16", x)
    if x.device.type == "cpu":
        return tanh_to_bf16_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"tanh_to_bf16 runs on CPU or CUDA, not {x.device}")
    if x.dim() == 0 or x.shape[-1] % 8:
        raise ValueError(f"the kernel needs a last dimension % 8 == 0, got shape {tuple(x.shape)}")
    _check("x", x, x.shape, x.device, torch.float32)
    _check_aligned("x", x)
    out = torch.empty(x.shape, device=x.device, dtype=torch.bfloat16)
    with torch.cuda.device(x.device):
        err = _lib().tanh_to_bf16_launch(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"tanh_to_bf16 launch failed: cudaError {err}")
    tanh_to_bf16.launches += 1
    return out


def input_proj_one(x, w_ih, b, *, reverse: bool = False):
    """Kernel 5: x (R, T, D) fp32, w_ih (4H, D), b (4H,) fp32 ->
    bf16 (T, R, 4H) of ``tanh(x) @ w_ih^T + b``, time-reversed with
    ``reverse``. On the card: the tanh pass, then the product."""
    refuse_autograd("input_proj_one", x, w_ih, b)
    if x.device.type == "cpu":
        return input_proj_one_reference(x, w_ih, b, reverse=reverse)
    if x.device.type != "cuda":
        raise ValueError(f"input_proj_one runs on CPU or CUDA, not {x.device}")
    (out,) = _launch(x, (w_ih,), (b,), (reverse,), fuse_tanh=True)
    input_proj_one.launches += 1
    return out


def input_proj_both(x, w_f, b_f, w_b, b_b, *, fuse_tanh: bool = True):
    """Kernel 6: both directions' projections from one pass over x (R, T, D),
    fp32 with ``fuse_tanh`` (tanh applied first, by the tanh pass on the
    card), else bf16.

    Returns ``(xf, xb_rev)``, bf16 (T, R, 4H) each, ``xb_rev`` time-reversed.
    """
    refuse_autograd("input_proj_both", x, w_f, b_f, w_b, b_b)
    if x.device.type == "cpu":
        return input_proj_both_reference(x, w_f, b_f, w_b, b_b, fuse_tanh=fuse_tanh)
    if x.device.type != "cuda":
        raise ValueError(f"input_proj_both runs on CPU or CUDA, not {x.device}")
    xf, xb = _launch(x, (w_f, w_b), (b_f, b_b), (False, True), fuse_tanh)
    input_proj_both.launches += 1
    return xf, xb


tanh_to_bf16.launches = 0
input_proj_one.launches = 0
input_proj_both.launches = 0
