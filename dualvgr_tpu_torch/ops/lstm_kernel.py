"""The BiLSTM recurrence: hand-written CUDA kernel and its plain version.

``bilstm_recurrence`` replaces the TPU kernel
``dualvgr_tpu/ops/lstm_pallas.py::bilstm_pallas`` with the same contract:
precomputed gates ``xproj_f`` (T, R, 4H) and time-reversed ``xproj_b_rev``
(T, R, 4H), recurrent weights ``w_hh_*`` (H, 4H), optional packed lengths,
and an optional (R, T, 2H) tensor of per-step outputs, zero at padding,
whose backward half is already back in original time order. The final
state is (R, 2H) = [h_fwd at len-1, h_bwd at t=0]. The gates may be fp32
or bf16 (``compute_dtype: bfloat16``; ``lstm_pallas.py:71-72``): the
recurrence runs in fp32 either way and ``final`` and ``outs`` come back in
the gates' dtype (``lstm_pallas.py:155-158``); W_hh stays fp32.

The wrapper calls the torch custom op ``dualvgr_torch::bilstm_recurrence``,
which ``torch.export`` keeps as one node, so an exported serving program
carries the kernel (``dualvgr_tpu_torch/export.py``). On a CPU tensor the
op runs ``bilstm_recurrence_reference``, the plain PyTorch loop; on a CUDA
tensor it launches ``csrc/bilstm_recurrence.cu`` through the shared
launch (``ops/launch.py``) or raises, and counts the launch in
``bilstm_recurrence.launches``. What bounds the kernel on the H100
and what its design does about it is written in ``csrc/bilstm_cluster.cuh``,
which kernel 3 shares: each CTA of a thread-block cluster keeps its
slice of W_hh in shared memory for the whole launch, persistent clusters
walk (direction, row tile) items over all T steps, and the new h goes to
every CTA of the cluster through distributed shared memory. The launch
plan is ``recurrence_plan``, here, so the CPU tests cover it, and the
limit on the hidden size that kernels 1, 3 and 4 share is ``hidden_limit``.
The work is fp32 FMA on the CUDA cores, so the bound is set by operations.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.launch import (
    OPS_NAMESPACE, call, check, dispatch, int32_lengths, launch, ptr, refuse_autograd,
)

MAX_HIDDEN = 384  # kMaxHidden in csrc/bilstm_cluster.cuh

# The cluster kernel's build constants (csrc/bilstm_cluster.cuh), which the
# plan mirrors: rows per tile (kRows), gate columns a CTA holds (kGateCols,
# so kGateCols / 4 hidden units), the buffers of the product's partial sums
# and their row stride (kRedBuffers, kRedStride), the cluster sizes tried,
# and the shared memory a block may use on the H100 (kSmemLimit). The CPU
# tests read the header's values against these, and the card tests hold
# ``smem_bytes`` against the libraries' own (``<prefix>_smem_bytes``).
ROWS_PER_TILE = 16
GATE_COLS = 96
RED_BUFFERS, RED_STRIDE = 4, GATE_COLS + 16
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SMEM_LIMIT = 232_448


@dataclass(frozen=True)
class RecurrencePlan:
    """How one launch of kernel 1, 3 or 4 spreads over the card: ``clusters``
    clusters of ``cluster`` CTAs; each CTA owns ``units`` hidden units (the
    last ones fewer, or none); each cluster walks at most
    ``tiles_per_cluster`` of the ``2 * tiles`` (direction, row tile) items;
    ``smem_bytes`` of dynamic shared memory per CTA."""

    cluster: int
    units: int
    rows_per_tile: int
    tiles: int
    clusters: int
    tiles_per_cluster: int
    smem_bytes: int


def smem_bytes(hidden, padded):
    """One CTA's shared memory: two mbarriers (16 bytes), then in fp32 the
    W slice (GATE_COLS columns of H + 4), h twice (rows of the ``padded`` =
    cluster x units hidden size), the product's partial sums (RED_BUFFERS x
    rows of RED_STRIDE) and the staged h slice twice (rows of GATE_COLS / 4)."""
    rows = ROWS_PER_TILE
    return 16 + 4 * (GATE_COLS * (hidden + 4) + 2 * rows * padded + RED_BUFFERS * rows * RED_STRIDE
                     + 2 * rows * GATE_COLS // 4)


def bwd_smem_bytes(hidden, padded):
    """One CTA's shared memory in kernel 4 (csrc/bilstm_train_bwd.cu, on the
    forward's build constants): two mbarriers (16 bytes), then in fp32 the
    W slice (GATE_COLS columns of H + 4), the dgates tile (rows of
    GATE_COLS) and the dh partials' receive buffer (rows of the ``padded``
    = cluster x units hidden size)."""
    rows = ROWS_PER_TILE
    return 16 + 4 * (GATE_COLS * (hidden + 4) + rows * GATE_COLS + rows * padded)


def hidden_limit(hidden):
    """Why the BiLSTM kernels (1, 3 and 4) cannot take hidden size
    ``hidden``, or None if they can: H a positive multiple of 4 (the h
    exchange moves 16 bytes a store), at most MAX_HIDDEN."""
    if hidden <= 0 or hidden % 4 or hidden > MAX_HIDDEN:
        return f"the BiLSTM kernels take hidden size {hidden} only if H % 4 == 0 and H <= {MAX_HIDDEN}"
    return None


def gate_hidden(g):
    """H of ``g`` = 4H gate columns; raises ``ValueError`` where the
    kernels cannot take it."""
    hidden = g // 4 if g % 4 == 0 else g / 4
    if (msg := hidden_limit(hidden)) is not None:
        raise ValueError(msg)
    return hidden


def cluster_shape(hidden):
    """``(cluster, units)``: the smallest cluster whose CTAs' slices hold
    all ``hidden`` units, each CTA at most GATE_COLS / 4 of them, a
    multiple of 4."""
    if (msg := hidden_limit(hidden)) is not None:
        raise ValueError(msg)
    for cluster in CLUSTER_SIZES:
        units = 4 * -(-hidden // (4 * cluster))
        if units <= GATE_COLS // 4:
            return cluster, units
    raise ValueError(f"hidden size {hidden} needs more than {CLUSTER_SIZES[-1]} CTAs")


def recurrence_plan(rows, hidden, active_clusters):
    """The launch plan of kernels 1 and 3 for R = ``rows``, H = ``hidden``
    on a card that keeps ``active_clusters`` clusters resident at once: as
    many clusters as that, or as there are items, walk the 2 x ceil(R /
    ROWS_PER_TILE) items between them (``cluster_items``)."""
    return _plan(rows, hidden, active_clusters, smem_bytes)


def backward_plan(rows, hidden, active_clusters):
    """The launch plan of kernel 4: kernel 3's, with ``bwd_smem_bytes``."""
    return _plan(rows, hidden, active_clusters, bwd_smem_bytes)


def _plan(rows, hidden, active_clusters, smem):
    rows_per_tile = ROWS_PER_TILE
    if rows <= 0:
        raise ValueError(f"rows must be positive, got {rows}")
    if active_clusters < 1:
        raise RuntimeError(f"the card keeps no cluster of the recurrence resident (H = {hidden})")
    cluster, units = cluster_shape(hidden)
    tiles = -(-rows // rows_per_tile)
    clusters = min(active_clusters, 2 * tiles)
    return RecurrencePlan(cluster=cluster, units=units, rows_per_tile=rows_per_tile, tiles=tiles,
                          clusters=clusters, tiles_per_cluster=-(-2 * tiles // clusters),
                          smem_bytes=smem(hidden, cluster * units))


def cta_units(plan, hidden, rank):
    """The hidden units CTA ``rank`` of a cluster owns, as the kernel
    computes them."""
    unit0 = rank * plan.units
    return range(min(unit0, hidden), min(unit0 + plan.units, hidden))


def cluster_items(plan, c):
    """The (direction, row tile) items cluster ``c`` walks, in order, as
    the kernel computes them."""
    total = 2 * plan.tiles
    return [divmod(i, plan.tiles) for i in range(c * total // plan.clusters, (c + 1) * total // plan.clusters)]


_active: dict = {}


def active_clusters(prefix, hidden, code, dev=None):
    """How many clusters of kernel ``prefix`` (its source ``<prefix>.cu``)
    the card keeps resident at once (``cudaOccupancyMaxActiveClusters``),
    asked once per library in place, H and gate type (``code`` None for
    kernel 4, which has one type). Raises if the card refuses the cluster."""
    key = (_build.load(f"{prefix}.cu"), hidden, code)
    if key not in _active:
        cluster, units = cluster_shape(hidden)
        n = call(f"{prefix}_active_clusters", dev, hidden, cluster, units, *(() if code is None else (code,)))
        if n <= 0:
            raise RuntimeError(f"{prefix}: the card keeps no cluster of {cluster} CTAs resident "
                               f"(H = {hidden}; cudaError {-n})")
        _active[key] = n
    return _active[key]


def library_smem_bytes(prefix, hidden):
    """The shared memory per CTA that kernel ``prefix``'s library in place
    launches with at hidden size ``hidden`` (the build's own formula)."""
    return call(f"{prefix}_smem_bytes", None, hidden, *cluster_shape(hidden))


def launch_plan(prefix, rows, hidden, code, dev=None, plan=recurrence_plan):
    """The plan for one launch of kernel ``prefix`` on ``dev`` (``plan``:
    ``recurrence_plan`` for kernels 1 and 3, ``backward_plan`` for
    kernel 4)."""
    return plan(rows, hidden, active_clusters(prefix, hidden, code, dev))


def plan_args(plan):
    """The plan's numbers in the order the C entries take them."""
    return plan.cluster, plan.units, plan.rows_per_tile, plan.clusters


def _lstm_step(gates, c):
    """One step: ``(h, c, (i, f, g, o))``, the last the gate activations."""
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c = f * c + i * g
    return o * torch.tanh(c), c, (i, f, g, o)


def recurrence_loop(xf, xb_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False,
                    keep_states: bool = False):
    """The plain BiLSTM recurrence over precomputed gates.

    Returns ``(final, outs, hprev, cprev, acts)``: ``outs`` (R, T, 2H) or
    None without ``with_outputs``; with ``keep_states`` the pre-step states
    ``(h_{t-1}, c_{t-1})`` of every step, (T, R, 2H) each in kernel time
    (the backward half time-reversed), and the gate activations (sigmoid
    i, sigmoid f, tanh g, sigmoid o), (2, T, R, 4H) direction-major in
    kernel time, zero at a masked step; else None for all three.
    """
    t_total, r, g = xf.shape
    hidden = g // 4
    # the state in the weights' dtype: fp32 for fp32 or bf16 gates
    hf = cf = hb = cb = w_hh_f.new_zeros((r, hidden))
    if lengths is not None:
        lens = lengths.to(device=xf.device, dtype=torch.int64).view(r, 1)
    outs_f, outs_b, hprev, cprev, acts_f, acts_b = [], [], [], [], [], []
    for t in range(t_total):
        if keep_states:
            hprev.append(torch.cat([hf, hb], dim=-1))
            cprev.append(torch.cat([cf, cb], dim=-1))
        hf_new, cf_new, af = _lstm_step(xf[t] + hf @ w_hh_f, cf)
        hb_new, cb_new, ab = _lstm_step(xb_rev[t] + hb @ w_hh_b, cb)
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
        if keep_states:
            af, ab = torch.cat(af, dim=-1), torch.cat(ab, dim=-1)
            if lengths is not None:
                af, ab = torch.where(m_f, af, 0.0), torch.where(m_b, ab, 0.0)
            acts_f.append(af)
            acts_b.append(ab)
        if with_outputs:
            outs_f.append(out_f)
            outs_b.append(out_b)
    final = torch.cat([hf, hb], dim=-1)
    outs = None
    if with_outputs:
        outs = torch.cat([torch.stack(outs_f, 1), torch.stack(outs_b[::-1], 1)], dim=-1)
    if not keep_states:
        return final, outs, None, None, None
    acts = torch.stack([torch.stack(acts_f), torch.stack(acts_b)])
    return final, outs, torch.stack(hprev), torch.stack(cprev), acts


def bilstm_recurrence_reference(
    xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False
):
    """Plain PyTorch version of the recurrence, with the kernel's contract."""
    final, outs, _, _, _ = recurrence_loop(
        xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs
    )
    final = final.to(xproj_f.dtype)
    return (final, outs.to(xproj_f.dtype)) if with_outputs else final


GATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the sources' gate_dtype argument


def gate_dtype_code(name, t):
    """The ``gate_dtype`` code of gates ``t`` (fp32 or bf16); raises on any other."""
    if t.dtype not in GATE_DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or bfloat16")
    return GATE_DTYPES[t.dtype]


def bilstm_recurrence(
    xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths=None, *, with_outputs: bool = False
):
    """Fused BiLSTM recurrence (see the module docstring for the contract).

    Returns ``final`` (R, 2H), or ``(final, outs)`` with ``with_outputs``.
    Raises if grad mode is on and an input requires grad (``refuse_autograd``).
    The work is the custom op ``dualvgr_torch::bilstm_recurrence``, so that
    ``torch.export`` keeps the kernel as one node of the graph.
    """
    refuse_autograd("bilstm_recurrence", xproj_f, xproj_b_rev, w_hh_f, w_hh_b)
    op = dispatch("bilstm_recurrence", xproj_f, _recurrence_op, _recurrence_op)
    final, outs = op(xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs)
    return (final, outs) if with_outputs else final


bilstm_recurrence.launches = 0


@torch.library.custom_op(f"{OPS_NAMESPACE}::bilstm_recurrence", mutates_args=(), device_types="cpu")
def _recurrence_op(xproj_f: torch.Tensor, xproj_b_rev: torch.Tensor, w_hh_f: torch.Tensor,
                   w_hh_b: torch.Tensor, lengths: torch.Tensor | None,
                   with_outputs: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version. ``outs`` is empty without
    ``with_outputs`` (an op has one output signature)."""
    res = bilstm_recurrence_reference(xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs=with_outputs)
    return res if with_outputs else (res, xproj_f.new_empty(0))


@_recurrence_op.register_fake
def _(xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs):
    t_total, r, g = xproj_f.shape
    final = xproj_f.new_empty((r, g // 2))
    return final, xproj_f.new_empty((r, t_total, g // 2) if with_outputs else (0,))


@_recurrence_op.register_kernel("cuda")
def _recurrence_cuda(xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs):
    """The op on CUDA tensors: one launch of ``csrc/bilstm_recurrence.cu``."""
    dev = xproj_f.device
    if xproj_f.dim() != 3:
        raise ValueError(f"xproj_f must be (T, R, 4H), got {tuple(xproj_f.shape)}")
    t_total, r, g = xproj_f.shape
    hidden = gate_hidden(g)
    code = gate_dtype_code("xproj_f", xproj_f)
    check("xproj_f", xproj_f, (t_total, r, g), dev, xproj_f.dtype)
    check("xproj_b_rev", xproj_b_rev, (t_total, r, g), dev, xproj_f.dtype)
    check("w_hh_f", w_hh_f, (hidden, g), dev)
    check("w_hh_b", w_hh_b, (hidden, g), dev)
    lengths = int32_lengths(lengths, r, dev)
    final = torch.empty((r, 2 * hidden), device=dev, dtype=xproj_f.dtype)
    outs = torch.empty((r, t_total, 2 * hidden) if with_outputs else (0,), device=dev, dtype=xproj_f.dtype)
    plan = launch_plan("bilstm_recurrence", r, hidden, code, dev)
    launch(bilstm_recurrence, "bilstm_recurrence_launch", dev,
           xproj_f.data_ptr(), xproj_b_rev.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
           ptr(lengths), final.data_ptr(), outs.data_ptr() if with_outputs else None,
           t_total, r, hidden, code, *plan_args(plan))
    return final, outs
