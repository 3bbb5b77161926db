"""The fused DualVGR graph cycle: hand-written CUDA kernel and plain version.

``gat_cycle`` replaces the TPU kernel
``dualvgr_tpu/ops/gat_pallas.py::fused_gat_cycle`` with the same arguments:
h (B, N, D), scores (B, N, hd); for the common and the specific GAT the
head-merged kernel w (D, H*hd), its bias (H*hd,), the attention vector
a (H, 2*hd) and its bias (H,); for AttentionSFGCN proj_w (D, D),
proj_b (D,) and score_w (D, 1). It returns (out, common, spec) with
out = h + SFGCN([common, spec]).

On a CPU tensor the wrapper runs ``gat_cycle_reference``; on a CUDA tensor
it launches ``csrc/gat_cycle.cu`` or raises. That source says what bounds
the kernel on the H100 and what its design does about it: one block per
video keeps the N x D tiles in shared memory and computes the four D x D
products itself, fp32 on the CUDA cores, so it is bound by operations.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.lstm_kernel import _check, refuse_autograd

MAX_NODES = 20
MAX_DIM = 768  # kThreads * kCols in the source
ALPHA = 0.01  # LeakyReLU slope of the GAT logits


def _gat_block(x, scores, w, b, a, a_bias):
    """One punished multi-head GAT over x (B, N, D) -> (B, N, H*hd)."""
    bsz, n, _ = x.shape
    heads, hd = a.shape[0], a.shape[1] // 2
    wh = (x @ w + b).view(bsz, n, heads, hd)
    src = torch.einsum("bnhd,hd->bhn", wh, a[:, :hd])
    dst = torch.einsum("bnhd,hd->bhn", wh, a[:, hd:])
    e = F.leaky_relu(src[..., :, None] + dst[..., None, :] + a_bias[None, :, None, None], ALPHA)
    attn = torch.softmax(e, dim=-1)  # (B, H, N, N); the dense adjacency masks nothing
    out = torch.einsum("bhij,bjhd->bihd", attn, wh * scores[:, :, None, :])
    return F.elu(out).reshape(bsz, n, heads * hd)


def gat_cycle_reference(
    h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w
):
    """Plain PyTorch version of the cycle, with the kernel's contract."""
    common = _gat_block(h, scores, wc, bc, ac, ac_bias)
    spec = _gat_block(h, scores, ws, bs, a_s, as_bias)

    def score(z):
        return torch.tanh(z @ proj_w + proj_b) @ score_w  # (B, N, 1)

    beta = torch.sigmoid(score(common) - score(spec))
    return h + (beta * common + (1.0 - beta) * spec), common, spec


def _launch_fn():
    fn = _build.load("gat_cycle.cu").gat_cycle_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 14
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def gat_cycle(h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w):
    """One stream's cycle (see the module docstring). Returns (out, common, spec).
    Eval only: raises if grad mode is on and an input requires grad (the
    JAX package gives the TPU kernel no backward either)."""
    args = (h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w)
    refuse_autograd("gat_cycle", *args)
    if h.device.type == "cpu":
        return gat_cycle_reference(*args)
    if h.device.type != "cuda":
        raise ValueError(f"gat_cycle runs on CPU or CUDA, not {h.device}")
    dev = h.device
    if h.dim() != 3:
        raise ValueError(f"h must be (B, N, D), got {tuple(h.shape)}")
    bsz, n, d = h.shape
    heads = ac.shape[0]
    hd = ac.shape[1] // 2
    if n > MAX_NODES or d > MAX_DIM or d % 4 or heads * hd != d:
        raise ValueError(
            f"gat_cycle takes N <= {MAX_NODES}, D <= {MAX_DIM}, D % 4 == 0 and "
            f"H*hd == D; got N={n}, D={d}, H={heads}, hd={hd}"
        )
    _check("h", h, (bsz, n, d), dev)
    for name, t, shape in (
        ("wc", wc, (d, d)), ("bc", bc, (d,)), ("ac", ac, (heads, 2 * hd)), ("ac_bias", ac_bias, (heads,)),
        ("ws", ws, (d, d)), ("bs", bs, (d,)), ("a_s", a_s, (heads, 2 * hd)), ("as_bias", as_bias, (heads,)),
        ("proj_w", proj_w, (d, d)), ("proj_b", proj_b, (d,)), ("score_w", score_w, (d, 1)),
    ):
        _check(name, t, shape, dev)
    # scores are read through their strides: QueryPunish's per-clip score
    # broadcast to the head width (stride 0) needs no copy
    if scores.device != dev or scores.dtype != torch.float32 or tuple(scores.shape) != (bsz, n, hd):
        raise ValueError(
            f"scores must be float32 ({bsz}, {n}, {hd}) on {dev}, got "
            f"{scores.dtype} {tuple(scores.shape)} on {scores.device}"
        )
    if min(scores.stride()) < 0:
        raise ValueError("scores must have non-negative strides")
    out, common, spec = (torch.empty_like(h) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launch_fn()(
            h.data_ptr(), scores.data_ptr(), *scores.stride(),
            wc.data_ptr(), bc.data_ptr(), ac.data_ptr(), ac_bias.data_ptr(),
            ws.data_ptr(), bs.data_ptr(), a_s.data_ptr(), as_bias.data_ptr(),
            proj_w.data_ptr(), proj_b.data_ptr(), score_w.data_ptr(),
            out.data_ptr(), common.data_ptr(), spec.data_ptr(),
            bsz, n, d, heads, stream,
        )
    if err != 0:
        raise RuntimeError(f"gat_cycle launch failed: cudaError {err}")
    gat_cycle.launches += 1
    return out, common, spec


gat_cycle.launches = 0
