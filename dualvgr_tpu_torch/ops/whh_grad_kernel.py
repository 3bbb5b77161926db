"""The recurrent weight gradient of a trainable BiLSTM: kernel 9 and its plain version.

``whh_grad_f32`` gives both directions' ``dW_hh = sum over (t, r) of
hprev[t, r]^T dgates[t, r]``, (H, 4H) each, from kernel 3's pre-step states
``hprev`` (T, R, 2H) and kernel 4's dgates ``dxf``, ``dxb`` (T, R, 4H), all
fp32 and in kernel time, where they lie. It replaces no TPU kernel: the
JAX package leaves the product to XLA (``dualvgr_tpu/ops/lstm_pallas_train.py:274-277``).
On a CPU tensor it runs ``whh_grad_f32_reference``, the two plain fp32
products the BiLSTM's backward ran before kernel 9, one per direction, and
the oracle of the tests; on a CUDA tensor the custom op
``dualvgr_torch::whh_grad_f32``, one launch of ``csrc/whh_grad_f32.cu``
(3xTF32 on the tensor cores: hprev's split pass, the product over K split
by ``whh_grad_plan`` so that its units fill the card's SMs, and the pass
that sums the splits in order and writes dW), through the shared launch
(``ops/launch.py``). ``launches`` counts one a call, and the tracer's
``lstm.tc_f32_whh_rows`` the rows R*T it sums. It records nothing for
autograd: ``ops/lstm_train.py``'s Functions call it in their backward.

The kernel takes every H: its TMA strides are 16H bytes (the dgates' rows)
and 4 R_pad (its scratch, R_pad = R rounded up to 4), multiples of 16 at
every width, so it adds no limit to ``models/dualvgr.py::kernel_dim_limits``.
"""

from __future__ import annotations

import functools

import torch

from dualvgr_tpu_torch.ops.launch import OPS_NAMESPACE, call, check, check_aligned, dispatch, launch, refuse_autograd
from dualvgr_tpu_torch.utils.trace import count

# the product's tile and k-block (csrc/whh_grad_f32.cu: kBM, kBN, kBK)
TILE_M, TILE_N, K_BLOCK = 128, 128, 32
# the most splits the entry takes (kMaxSplits)
MAX_SPLITS = 1024
# k-blocks' worth of time a unit costs beyond its k-blocks (its fill and
# its partial's store), in ``whh_grad_plan``'s count
UNIT_OVERHEAD = 2


def whh_grad_f32_reference(hprev, dxf, dxb):
    """Plain PyTorch version of kernel 9: ``(dw_f, dw_b)``, (H, 4H) each, one
    fp32 product per direction over ``(T*R, H)^T @ (T*R, 4H)``."""
    hidden, g = hprev.shape[-1] // 2, dxf.shape[-1]
    dwf = hprev[..., :hidden].reshape(-1, hidden).t() @ dxf.reshape(-1, g)
    dwb = hprev[..., hidden:].reshape(-1, hidden).t() @ dxb.reshape(-1, g)
    return dwf, dwb


def tiles(hidden):
    """The product's 128 x 128 output tiles: both directions' 4H gates by H."""
    return 2 * -(-4 * hidden // TILE_M) * -(-hidden // TILE_N)


@functools.lru_cache(maxsize=64)
def whh_grad_plan(r, t, hidden, sms):
    """The number of splits of K = R*T (whole k-blocks of 32 rows of one
    step) for ``sms`` SMs: the fewest that take the least time, counted as
    waves of units (splits x tiles over the SMs) times the k-blocks of the
    longest split plus ``UNIT_OVERHEAD``. At H 384 (72 tiles) on 132 SMs:
    11, 792 units in 6 full waves."""
    k_blocks = t * -(-r // K_BLOCK)
    n = tiles(hidden)
    cost = lambda s: -(-n * s // sms) * (-(-k_blocks // s) + UNIT_OVERHEAD)
    return min(range(1, min(k_blocks, MAX_SPLITS) + 1), key=lambda s: (cost(s), s))


def sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def library_smem_bytes():
    """The dynamic shared memory of kernel 9's CTA, the build's own."""
    return call("whh_grad_f32_smem_bytes", None)


def whh_grad_f32(hprev, dxf, dxb):
    """Kernel 9: both directions' fp32 recurrent weight gradients from
    hprev (T, R, 2H) and the dgates dxf, dxb (T, R, 4H), all in kernel time.

    Returns ``(dw_f, dw_b)``, fp32 (H, 4H) each: ``sum over (t, r) of
    hprev[t, r, :H]^T dxf[t, r]`` and of ``hprev[t, r, H:]^T dxb[t, r]``.
    """
    refuse_autograd("whh_grad_f32", hprev, dxf, dxb)
    return dispatch("whh_grad_f32", hprev, whh_grad_f32_reference, _whh_op)(hprev, dxf, dxb)


@torch.library.custom_op(f"{OPS_NAMESPACE}::whh_grad_f32", mutates_args=(), device_types="cpu")
def _whh_op(hprev: torch.Tensor, dxf: torch.Tensor, dxb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version."""
    return whh_grad_f32_reference(hprev, dxf, dxb)


@_whh_op.register_fake
def _(hprev, dxf, dxb):
    return tuple(hprev.new_empty((hprev.shape[-1] // 2, dxf.shape[-1])) for _ in range(2))


@_whh_op.register_kernel("cuda")
def _whh_cuda(hprev, dxf, dxb, splits=None):
    """The op on CUDA tensors: one launch of ``csrc/whh_grad_f32.cu`` with K
    cut into ``splits`` (None: ``whh_grad_plan``'s for the card). hprev's
    TF32 halves, K-major (2H, T, R_pad), and the splits' partial tiles go
    to scratch made here; counts R*T in ``lstm.tc_f32_whh_rows``."""
    dev = hprev.device
    if hprev.dim() != 3 or hprev.shape[-1] % 2 or hprev.shape[-1] == 0:
        raise ValueError(f"hprev must be (T, R, 2H), got {tuple(hprev.shape)}")
    t, r, c = hprev.shape
    hidden = c // 2
    for name, a, shape in (("hprev", hprev, (t, r, c)), ("dxf", dxf, (t, r, 4 * hidden)),
                           ("dxb", dxb, (t, r, 4 * hidden))):
        check(name, a, shape, dev, torch.float32)
        check_aligned(name, a)
    if splits is None:
        splits = whh_grad_plan(r, t, hidden, sm_count(dev))
    r_pad = -(-r // 4) * 4  # TMA's 16-byte strides
    split = torch.empty((2, c, t, r_pad), device=dev, dtype=torch.float32)
    partial = torch.empty((splits * tiles(hidden), TILE_M, TILE_N), device=dev, dtype=torch.float32)
    dw_f, dw_b = (torch.empty((hidden, 4 * hidden), device=dev, dtype=torch.float32) for _ in range(2))
    launch(whh_grad_f32, "whh_grad_f32_launch", dev, hprev.data_ptr(), dxf.data_ptr(), dxb.data_ptr(),
           split.data_ptr(), partial.data_ptr(), dw_f.data_ptr(), dw_b.data_ptr(), r, t, hidden, r_pad, splits)
    count("lstm.tc_f32_whh_rows", r * t)
    return dw_f, dw_b


whh_grad_f32.launches = 0
