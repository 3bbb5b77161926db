"""The wrappers of the hand-written kernels: one device rule, their checks, one launch.

A wrapper runs its plain version (``*_reference``) on CPU tensors and its
kernel on CUDA tensors, and raises ``ValueError`` on any other device
(``dispatch``). It checks the tensors it hands the kernel (``check``,
``check_aligned``, ``int32_lengths``) and refuses inputs that require
grad (``refuse_autograd``). ``launch`` calls a kernel's entry, declared in
``_build.ENTRIES``, under the device's guard with its current stream,
turns a nonzero return into ``RuntimeError`` and counts the launch in the
wrapper's ``.launches``; ``call`` is the same for the plan helpers'
queries, which take no stream and return a number.
"""

from __future__ import annotations

import torch

from dualvgr_tpu_torch.ops import _build

# the namespace of the kernels' torch custom ops (``torch.ops.dualvgr_torch``)
OPS_NAMESPACE = "dualvgr_torch"


def dispatch(name, t, reference, kernel):
    """``reference`` where ``t`` is on the CPU, ``kernel`` where it is on a
    CUDA device; raises ``ValueError`` naming wrapper ``name`` on any other."""
    if t.device.type == "cpu":
        return reference
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"{name} runs on CPU or CUDA, not {t.device}")


def refuse_autograd(name, *tensors):
    """Raise where a kernel would silently cut the autograd graph.

    The kernels launch through ctypes and record nothing for autograd, so
    with grad mode on, an input that requires grad would come back with
    detached outputs and its weights would get no gradient. Runs before
    the device dispatch, on CPU tensors too. The trainable BiLSTM goes
    through ``ops/lstm_train.py``, whose Functions call the kernels with
    grad mode off.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} records nothing for autograd, and an input requires grad: call it "
            "under torch.no_grad(), or use the trainable ops of dualvgr_tpu_torch.ops.lstm_train"
        )


def check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_aligned(name, t):
    """TMA and the 16-byte vector accesses need 16-byte aligned data."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte aligned address (storage offset {t.storage_offset()})")


def int32_lengths(lengths, r, dev):
    """``lengths`` as contiguous int32 on ``dev`` (None stays None); raises
    unless it is integer (R,)."""
    if lengths is None:
        return None
    if lengths.dtype.is_floating_point or tuple(lengths.shape) != (r,):
        raise ValueError(f"lengths must be integer (R,) = ({r},), got {lengths.dtype} {tuple(lengths.shape)}")
    return lengths.to(device=dev, dtype=torch.int32).contiguous()


def ptr(t):
    """A tensor's address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def call(entry, dev, *args):
    """Entry ``entry`` of the port's libraries on ``args`` under ``dev``'s
    guard (None: the current device); returns what it returns."""
    fn = _build.entry(entry)
    with torch.cuda.device(dev):
        return fn(*args)


def launch(wrapper, entry, dev, *args):
    """One launch: entry ``entry`` on ``args`` and then ``dev``'s current
    stream, under ``dev``'s guard. Raises ``RuntimeError`` if it returns a
    cudaError; else counts one launch in ``wrapper.launches``."""
    err = call(entry, dev, *args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry.removesuffix('_launch')} launch failed: cudaError {err}")
    wrapper.launches += 1
