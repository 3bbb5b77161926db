"""The BiLSTM recurrence: hand-written CUDA kernel and its plain version.

``bilstm_recurrence`` replaces the TPU kernel
``dualvgr_tpu/ops/lstm_pallas.py::bilstm_pallas`` with the same contract:
precomputed gates ``xproj_f`` (T, R, 4H) and time-reversed ``xproj_b_rev``
(T, R, 4H), recurrent weights ``w_hh_*`` (H, 4H), optional packed lengths,
and an optional (R, T, 2H) tensor of per-step outputs, zero at padding,
whose backward half is already back in original time order. The final
state is (R, 2H) = [h_fwd at len-1, h_bwd at t=0].

On a CPU tensor the wrapper runs ``bilstm_recurrence_reference``, the
plain PyTorch loop; on a CUDA tensor it launches
``csrc/bilstm_recurrence.cu`` or raises. What bounds the kernel on the H100
and what its design does about it is written at the top of that source:
one block per (row tile, direction) loops over T with h and c in shared
memory, and streams W_hh (2.36 MB per direction at H=384) from L2 on every
step; the tile shape (16 rows, or 4 when R is too small to give every SM a
block) is chosen at launch. The work is fp32 FMA on the CUDA cores, so the
bound is set by operations.
"""

from __future__ import annotations

import ctypes

import torch

from dualvgr_tpu_torch.ops import _build

MAX_HIDDEN = 384  # kTx * kUnitsPerThread in the source


def _lstm_step(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm_recurrence_reference(
    xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False
):
    """Plain PyTorch version of the recurrence, with the kernel's contract."""
    t_total, r, g = xproj_f.shape
    hidden = g // 4
    hf = cf = hb = cb = xproj_f.new_zeros((r, hidden))
    if lengths is not None:
        lens = lengths.to(device=xproj_f.device, dtype=torch.int64).view(r, 1)
    outs_f, outs_b = [], []
    for t in range(t_total):
        hf_new, cf_new = _lstm_step(xproj_f[t] + hf @ w_hh_f, cf)
        hb_new, cb_new = _lstm_step(xproj_b_rev[t] + hb @ w_hh_b, cb)
        if lengths is None:
            hf, cf, hb, cb = hf_new, cf_new, hb_new, cb_new
            out_f, out_b = hf, hb
        else:
            # forward carries its state through padding; backward (reversed
            # time) stays at zero until it enters its valid region
            m_f = t < lens
            m_b = t >= t_total - lens
            hf, cf = torch.where(m_f, hf_new, hf), torch.where(m_f, cf_new, cf)
            hb, cb = torch.where(m_b, hb_new, hb), torch.where(m_b, cb_new, cb)
            out_f, out_b = hf * m_f, hb * m_b
        if with_outputs:
            outs_f.append(out_f)
            outs_b.append(out_b)
    final = torch.cat([hf, hb], dim=-1)
    if not with_outputs:
        return final
    outs = torch.cat([torch.stack(outs_f, 1), torch.stack(outs_b[::-1], 1)], dim=-1)
    return final, outs


def _launch_fn():
    fn = _build.load("bilstm_recurrence.cu").bilstm_recurrence_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bilstm_recurrence(
    xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False
):
    """Fused BiLSTM recurrence (see the module docstring for the contract).

    Returns ``final`` (R, 2H), or ``(final, outs)`` with ``with_outputs``.
    """
    if xproj_f.device.type == "cpu":
        return bilstm_recurrence_reference(
            xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs
        )
    if xproj_f.device.type != "cuda":
        raise ValueError(f"bilstm_recurrence runs on CPU or CUDA, not {xproj_f.device}")
    dev = xproj_f.device
    if xproj_f.dim() != 3:
        raise ValueError(f"xproj_f must be (T, R, 4H), got {tuple(xproj_f.shape)}")
    t_total, r, g = xproj_f.shape
    hidden = g // 4
    if g % 4 or hidden % 4 or hidden > MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} unsupported: needs H % 4 == 0 and H <= {MAX_HIDDEN}")
    _check("xproj_f", xproj_f, (t_total, r, g), dev)
    _check("xproj_b_rev", xproj_b_rev, (t_total, r, g), dev)
    _check("w_hh_f", w_hh_f, (hidden, g), dev)
    _check("w_hh_b", w_hh_b, (hidden, g), dev)
    lens_ptr = None
    if lengths is not None:
        if lengths.dtype.is_floating_point or tuple(lengths.shape) != (r,):
            raise ValueError(f"lengths must be integer (R,) = ({r},), got {lengths.dtype} {tuple(lengths.shape)}")
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
        lens_ptr = lengths.data_ptr()
    final = torch.empty((r, 2 * hidden), device=dev, dtype=torch.float32)
    outs = torch.empty((r, t_total, 2 * hidden), device=dev, dtype=torch.float32) if with_outputs else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn()(
            xproj_f.data_ptr(), xproj_b_rev.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
            lens_ptr, final.data_ptr(), outs.data_ptr() if with_outputs else None,
            t_total, r, hidden, stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm_recurrence launch failed: cudaError {err}")
    bilstm_recurrence.launches += 1
    return (final, outs) if with_outputs else final


bilstm_recurrence.launches = 0
