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
tensor it launches ``csrc/bilstm_recurrence.cu`` or raises, and counts the
launch in ``bilstm_recurrence.launches``. What bounds the kernel on the H100
and what its design does about it is written in ``csrc/bilstm_cluster.cuh``,
which kernel 3 shares: each CTA of a thread-block cluster keeps its
slice of W_hh in shared memory for the whole launch, persistent clusters
walk (direction, row tile) items over all T steps, and the new h goes to
every CTA of the cluster through distributed shared memory. The launch
plan is ``recurrence_plan``, here, so the CPU tests cover it. The work is
fp32 FMA on the CUDA cores, so the bound is set by operations.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from dualvgr_tpu_torch.ops import _build

MAX_HIDDEN = 384  # kMaxHidden in csrc/bilstm_cluster.cuh
# the namespace of the kernels' torch custom ops (``torch.ops.dualvgr_torch``)
OPS_NAMESPACE = "dualvgr_torch"

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


def cluster_shape(hidden):
    """``(cluster, units)``: the smallest cluster whose CTAs' slices hold
    all ``hidden`` units, each CTA at most GATE_COLS / 4 of them, a
    multiple of 4 (the h exchange moves 16 bytes a store)."""
    if hidden <= 0 or hidden % 4 or hidden > MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} unsupported: needs H % 4 == 0 and H <= {MAX_HIDDEN}")
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


def active_clusters(lib, prefix, hidden, code):
    """How many clusters of ``<prefix>``'s kernel in ``lib`` the card keeps
    resident at once (``cudaOccupancyMaxActiveClusters``), asked once per
    library, H and gate type (``code`` None for kernel 4, which has one
    type). Raises if the card refuses the cluster."""
    key = (id(lib), prefix, hidden, code)
    if key not in _active:
        cluster, units = cluster_shape(hidden)
        fn = getattr(lib, f"{prefix}_active_clusters")
        args = (hidden, cluster, units) + (() if code is None else (code,))
        fn.argtypes, fn.restype = [ctypes.c_int] * len(args), ctypes.c_int
        n = fn(*args)
        if n <= 0:
            raise RuntimeError(f"{prefix}: the card keeps no cluster of {cluster} CTAs resident "
                               f"(H = {hidden}; cudaError {-n})")
        _active[key] = n
    return _active[key]


def library_smem_bytes(lib, prefix, hidden):
    """The shared memory per CTA that ``<prefix>``'s kernel in ``lib``
    launches with at hidden size ``hidden`` (the build's own formula)."""
    cluster, units = cluster_shape(hidden)
    fn = getattr(lib, f"{prefix}_smem_bytes")
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return fn(hidden, cluster, units)


def launch_plan(lib, prefix, rows, hidden, code, plan=recurrence_plan):
    """The plan for one launch of ``<prefix>_launch`` in ``lib``
    (``plan``: ``recurrence_plan`` for kernels 1 and 3, ``backward_plan``
    for kernel 4)."""
    return plan(rows, hidden, active_clusters(lib, prefix, hidden, code))


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


GATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the sources' gate_dtype argument


def gate_dtype_code(name, t):
    """The ``gate_dtype`` code of gates ``t`` (fp32 or bf16); raises on any other."""
    if t.dtype not in GATE_DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or bfloat16")
    return GATE_DTYPES[t.dtype]


def launch_fn(source, prefix, n_ptrs, typed=True):
    """``(library, <prefix>_launch)`` of ``csrc/<source>``: ``n_ptrs``
    pointers, T, R, H, the gate type (unless not ``typed``: kernel 4) and
    the plan's four numbers, then the stream."""
    lib = _build.load(source)
    fn = getattr(lib, f"{prefix}_launch")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * (8 if typed else 7) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


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
    Raises if grad mode is on and an input requires grad (``refuse_autograd``).
    The work is the custom op ``dualvgr_torch::bilstm_recurrence``, so that
    ``torch.export`` keeps the kernel as one node of the graph.
    """
    refuse_autograd("bilstm_recurrence", xproj_f, xproj_b_rev, w_hh_f, w_hh_b)
    if xproj_f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bilstm_recurrence runs on CPU or CUDA, not {xproj_f.device}")
    final, outs = _recurrence_op(xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs)
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
def _(xproj_f, xproj_b_rev, w_hh_f, w_hh_b, lengths, with_outputs):
    """The op on CUDA tensors: one launch of ``csrc/bilstm_recurrence.cu``."""
    dev = xproj_f.device
    if xproj_f.dim() != 3:
        raise ValueError(f"xproj_f must be (T, R, 4H), got {tuple(xproj_f.shape)}")
    t_total, r, g = xproj_f.shape
    hidden = g // 4
    if g % 4 or hidden % 4 or hidden > MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} unsupported: needs H % 4 == 0 and H <= {MAX_HIDDEN}")
    code = gate_dtype_code("xproj_f", xproj_f)
    _check("xproj_f", xproj_f, (t_total, r, g), dev, xproj_f.dtype)
    _check("xproj_b_rev", xproj_b_rev, (t_total, r, g), dev, xproj_f.dtype)
    _check("w_hh_f", w_hh_f, (hidden, g), dev)
    _check("w_hh_b", w_hh_b, (hidden, g), dev)
    lens_ptr = None
    if lengths is not None:
        if lengths.dtype.is_floating_point or tuple(lengths.shape) != (r,):
            raise ValueError(f"lengths must be integer (R,) = ({r},), got {lengths.dtype} {tuple(lengths.shape)}")
        lengths = lengths.to(device=dev, dtype=torch.int32).contiguous()
        lens_ptr = lengths.data_ptr()
    final = torch.empty((r, 2 * hidden), device=dev, dtype=xproj_f.dtype)
    outs = torch.empty((r, t_total, 2 * hidden) if with_outputs else (0,), device=dev, dtype=xproj_f.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib, fn = launch_fn("bilstm_recurrence.cu", "bilstm_recurrence", 7)
        plan = launch_plan(lib, "bilstm_recurrence", r, hidden, code)
        err = fn(
            xproj_f.data_ptr(), xproj_b_rev.data_ptr(), w_hh_f.data_ptr(), w_hh_b.data_ptr(),
            lens_ptr, final.data_ptr(), outs.data_ptr() if with_outputs else None,
            t_total, r, hidden, code, *plan_args(plan), stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm_recurrence launch failed: cudaError {err}")
    bilstm_recurrence.launches += 1
    return final, outs
