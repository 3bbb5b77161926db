"""The trainable BiLSTM recurrence: hand-written CUDA kernels and plain versions.

The kernel half of ``dualvgr_tpu/ops/lstm_pallas_train.py``:

* ``bilstm_train_fwd`` replaces ``_run_fwd_m`` (body ``_fwd_kernel_m``):
  kernel 1's recurrence (``ops/lstm_kernel.py``), which also stores the
  pre-step states ``(h_{t-1}, c_{t-1})`` of every step as residuals.
  Returns ``(final, outs, hprev, cprev)``: final (R, 2H); outs (R, T, 2H)
  or None, zero at padding, the backward half back in original time order
  (kernel 1's layout; the TPU kernel keeps it in kernel time and flips it
  outside); hprev and cprev (T, R, 2H) in kernel time for both directions.
* ``bilstm_train_bwd`` replaces ``_run_bwd_m`` (body ``_bwd_kernel_m``): the
  reverse-time backward. It recomputes the gates from the residuals,
  carries ``(dh, dc)`` and returns ``(dxf, dxb)``, the gradients of the
  gate inputs (T, R, 4H) in kernel time, which are the dgates. ``douts``
  is read in the layout ``outs`` has. dW_hh is left to one plain product
  outside (``ops/lstm_train.py``), as the JAX package leaves it to XLA.

The inputs are kernel 1's: gates ``xf`` (T, R, 4H) and time-reversed
``xb_rev``, recurrent weights ``w_hh_*`` (H, 4H), optional (R,) lengths.
The gates may be fp32 or bf16 (the appearance op under ``compute_dtype:
bfloat16``, ``lstm_pallas_train.py:392-405``); the weights, the
residuals, ``final``, ``outs`` and the dgates are fp32 either way, as in
the TPU kernels. On a CPU tensor each wrapper runs its ``*_reference``,
the plain PyTorch loop; on a CUDA tensor it launches
``csrc/bilstm_train_fwd.cu`` or ``csrc/bilstm_train_bwd.cu`` or raises.
Both record nothing for autograd (``refuse_autograd``); the Functions of
``ops/lstm_train.py`` call them. What bounds each kernel and what its design does about it is
written at the top of its source.
"""

from __future__ import annotations

import ctypes

import torch

from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.lstm_kernel import (
    MAX_HIDDEN, _check, gate_dtype_code, recurrence_loop, refuse_autograd,
)


def bilstm_train_fwd_reference(xf, xb_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False):
    """Plain PyTorch version of the training forward, with the kernel's contract."""
    return recurrence_loop(xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs,
                           keep_states=True)


def bilstm_train_bwd_reference(xf, xb_rev, w_hh_f, w_hh_b, lengths, hprev, cprev, dfinal, douts=None):
    """Plain PyTorch version of the training backward, with the kernel's contract.

    With ``m`` the step's mask (1 without lengths), a masked step passes
    ``(1 - m)`` of the carried gradients straight to the previous step:
    ``dh~ = m (dh + m dout)``, ``dh_prev += (1 - m)(dh + m dout)``,
    ``dc~ = m dc``, ``dc_prev += (1 - m) dc``, so the dgates of a masked
    step are exactly zero.
    """
    t_total, r, g = xf.shape
    hidden = g // 4
    if lengths is not None:
        lens = lengths.to(device=xf.device, dtype=torch.int64).view(r, 1)
    # carries and dgates in the weights' dtype: fp32 for fp32 or bf16 gates
    one = w_hh_f.new_ones(())
    dxs = []
    for k, (x, w) in enumerate(((xf, w_hh_f), (xb_rev, w_hh_b))):
        cols = slice(k * hidden, (k + 1) * hidden)
        dx = w.new_empty(x.shape)
        dh, dc = dfinal[:, cols], w.new_zeros((r, hidden))
        for t in reversed(range(t_total)):
            h_prev, c_prev = hprev[t, :, cols], cprev[t, :, cols]
            gi, gf, gg, go = (x[t] + h_prev @ w).chunk(4, dim=-1)
            i, f, gc, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
            c = f * c_prev + i * gc
            tc = torch.tanh(c)
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


def _launch_fn(source, name, n_ptrs):
    fn = getattr(_build.load(source), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_common(name, xf, xb_rev, w_hh_f, w_hh_b, lengths):
    """Device, type, shape and contiguity checks shared by both wrappers;
    returns (device, T, R, H, lengths as contiguous int32 or None, the
    gates' dtype code)."""
    if xf.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, not {xf.device}")
    dev = xf.device
    if xf.dim() != 3:
        raise ValueError(f"xf must be (T, R, 4H), got {tuple(xf.shape)}")
    t_total, r, g = xf.shape
    hidden = g // 4
    if g % 4 or hidden % 4 or hidden > MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} unsupported: needs H % 4 == 0 and H <= {MAX_HIDDEN}")
    code = gate_dtype_code("xf", xf)
    _check("xf", xf, (t_total, r, g), dev, xf.dtype)
    _check("xb_rev", xb_rev, (t_total, r, g), dev, xf.dtype)
    _check("w_hh_f", w_hh_f, (hidden, g), dev)
    _check("w_hh_b", w_hh_b, (hidden, g), dev)
    if lengths is not None:
        if lengths.dtype.is_floating_point or tuple(lengths.shape) != (r,):
            raise ValueError(f"lengths must be integer (R,) = ({r},), got {lengths.dtype} {tuple(lengths.shape)}")
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
    return dev, t_total, r, hidden, lengths, code


def _ptr(t):
    return None if t is None else t.data_ptr()


def bilstm_train_fwd(xf, xb_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False):
    """Training forward (see the module docstring): ``(final, outs, hprev, cprev)``."""
    refuse_autograd("bilstm_train_fwd", xf, xb_rev, w_hh_f, w_hh_b)
    if xf.device.type == "cpu":
        return bilstm_train_fwd_reference(xf, xb_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs)
    dev, t_total, r, hidden, lengths, code = _check_common("bilstm_train_fwd", xf, xb_rev, w_hh_f, w_hh_b,
                                                           lengths)
    final = torch.empty((r, 2 * hidden), device=dev, dtype=torch.float32)
    outs = torch.empty((r, t_total, 2 * hidden), device=dev, dtype=torch.float32) if with_outputs else None
    hprev, cprev = (torch.empty((t_total, r, 2 * hidden), device=dev, dtype=torch.float32) for _ in range(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn("bilstm_train_fwd.cu", "bilstm_train_fwd_launch", 9)(
            xf.data_ptr(), xb_rev.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(), _ptr(lengths),
            final.data_ptr(), _ptr(outs), hprev.data_ptr(), cprev.data_ptr(),
            t_total, r, hidden, code, stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm_train_fwd launch failed: cudaError {err}")
    bilstm_train_fwd.launches += 1
    return final, outs, hprev, cprev


def bilstm_train_bwd(xf, xb_rev, w_hh_f, w_hh_b, lengths, hprev, cprev, dfinal, douts=None):
    """Training backward (see the module docstring): ``(dxf, dxb)``.
    ``douts`` is None for a final-only forward and is then never read."""
    refuse_autograd("bilstm_train_bwd", xf, xb_rev, w_hh_f, w_hh_b, hprev, cprev, dfinal, douts)
    if xf.device.type == "cpu":
        return bilstm_train_bwd_reference(xf, xb_rev, w_hh_f, w_hh_b, lengths, hprev, cprev, dfinal, douts)
    dev, t_total, r, hidden, lengths, code = _check_common("bilstm_train_bwd", xf, xb_rev, w_hh_f, w_hh_b,
                                                           lengths)
    _check("hprev", hprev, (t_total, r, 2 * hidden), dev)
    _check("cprev", cprev, (t_total, r, 2 * hidden), dev)
    _check("dfinal", dfinal, (r, 2 * hidden), dev)
    if douts is not None:
        _check("douts", douts, (r, t_total, 2 * hidden), dev)
    # the dh_prev = dgates @ W_hh^T product reads W_hh^T (4H, H), whose
    # columns are the hidden units: coalesced across the unit lanes
    w_t_f, w_t_b = w_hh_f.t().contiguous(), w_hh_b.t().contiguous()
    dxf, dxb = (torch.empty(xf.shape, device=dev, dtype=torch.float32) for _ in range(2))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn("bilstm_train_bwd.cu", "bilstm_train_bwd_launch", 13)(
            xf.data_ptr(), xb_rev.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
            w_t_f.data_ptr(), w_t_b.data_ptr(), _ptr(lengths), hprev.data_ptr(), cprev.data_ptr(),
            dfinal.data_ptr(), _ptr(douts), dxf.data_ptr(), dxb.data_ptr(),
            t_total, r, hidden, code, stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm_train_bwd launch failed: cudaError {err}")
    bilstm_train_bwd.launches += 1
    return dxf, dxb


bilstm_train_fwd.launches = 0
bilstm_train_bwd.launches = 0
