"""Tensor parallelism and ZeRO-1: a 2-D (data, model) mesh for the port.

The counterpart of the JAX package's ``parallel/tp.py``. There, the state
is laid out sharded over a ``model`` mesh axis and XLA's partitioner
inserts the collectives. PyTorch has no partitioner for an eager forward,
and a DTensor parameter cannot meet the plain tensors of the rest of the
forward (an op mixing the two raises), so the port places the state the
same way and computes on the local shards itself:

* **The rule** (``leaf_spec``, ``zero_leaf_spec``) is the JAX package's,
  applied to the JAX package's leaf shapes: a leaf is sharded on its last
  axis over ``model`` iff that axis divides evenly into shards of >= 8;
  ZeRO shards an optimizer-state leaf over the data axis on its first
  other axis that divides evenly. ``jax_layout`` maps every torch
  parameter to its JAX leaf through the port's own knowledge of the
  re-layout (``utils/weights.py``): a Dense or LSTM kernel (in, out) is the
  transposed torch ``weight``, so its last axis is the weight's dim 0; the
  embedding is the same in both; a GAT bank's (D, H, hd) kernel is split
  into per-head (hd, D) torch weights, so its head axis names whole
  tensors.
* **At rest** each rank holds its shard of every sharded parameter (and of
  its Adam moments and accumulated gradient) as a plain tensor;
  ``state_dtensors`` gives the same memory as DTensors with their
  placements (``Shard`` on the model axis), which ``tp_sharded_leaf_count``
  counts.
* **Compute** (``shard_state_tp``): every ``nn.Linear`` whose weight is
  sharded, the question embedding and each BiLSTM's input projection run
  column-parallel: the input's gradient is summed over the model axis
  (``copy_to_axis``), the product gives this rank's output columns, and the
  columns are all-gathered (``gather_columns``), so every activation after
  a layer is whole and the rest of the forward runs unchanged on every
  rank of the model axis. Every other sharded parameter (the GAT heads'
  ``W`` and ``a``, which the banks read merged, a GCN weight, the batch
  norm's scale and bias, the BiLSTMs' ``W_hh``) is all-gathered where it is
  read, through a parametrization; the recurrent product gathers ``W_hh``
  once per forward rather than ``h`` at every step. Buffers (the batch
  norm's running statistics) stay whole: every rank updates them alike.
* **ZeRO-1** (``shard_opt_state_zero``): each rank keeps Adam's moments for
  its slice of each parameter along the axis ``zero_leaf_spec`` names (a
  whole head's tensors where it names the head axis), runs
  ``torch.optim.Adam`` on views of those slices with the all-reduced
  gradient's slices, and all-gathers the updated slices (broadcasts a head
  from its owner). ``torch.distributed.optim.ZeroRedundancyOptimizer``
  shards whole parameters instead; slices along the JAX package's axes
  keep the layout it prescribes and the update is Adam's own code.

* **The gradient** is summed over the data axis by all-reduces that the
  backward launches bucket by bucket, as ``DistributedDataParallel``
  does (``_GradBuckets``, ``place_state(bucket_mb=)``), so that the
  communication overlaps the rest of the backward.

Only ``all_reduce``, ``broadcast`` and ``all_gather`` are used
(``parallel/comm.py``), which gloo has for CUDA tensors too. The kernels
are off under tensor parallelism, as in the JAX package
(``config.model_runtime_kwargs``).
"""

from __future__ import annotations

import types
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dualvgr_tpu_torch.parallel.comm import Axis, all_gather_cat, all_reduce_, broadcast_, copy_to_axis, gather_columns

DATA_AXIS = "data"
MODEL_AXIS = "model"
HEAD = "head"  # a JAX axis that the port holds as separate per-head tensors
BUCKET_MB = 25.0  # the gradient all-reduce's bucket (DistributedDataParallel's default)


def dp_tp_mesh(n_data: int, n_model: int, device_type: str = "cuda", data_axis: str = DATA_AXIS,
               model_axis: str = MODEL_AXIS):
    """2-D mesh of ``n_data`` x ``n_model`` ranks, axes (data, model), the
    model axis the faster-varying one (ranks r and r+1 share a data index),
    so the collectives inside every layer run between neighbouring ranks.
    Needs exactly ``n_data * n_model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if data_axis == model_axis:
        raise ValueError(f"the data axis cannot be named {model_axis!r}, the model axis's name")
    world = dist.get_world_size()
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} ranks, have {world}")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=(data_axis, model_axis))


def leaf_spec(shape, n_model: int, min_shard: int = 8) -> tuple:
    """The JAX package's PartitionSpec, as a tuple, for one leaf of JAX shape
    ``shape`` under TP degree ``n_model``: the last axis over ``model`` iff
    it divides evenly with >= ``min_shard`` columns a shard, else ()."""
    if n_model <= 1 or not shape:
        return ()
    last = shape[-1]
    if last % n_model == 0 and last // n_model >= min_shard:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def zero_leaf_spec(shape, n_data: int, n_model: int, data_axis: str = DATA_AXIS, min_shard: int = 8) -> tuple:
    """ZeRO spec of an optimizer-state leaf: its parameter's TP spec plus the
    first other axis that divides evenly over the data axis."""
    base = list(leaf_spec(shape, n_model, min_shard))
    base += [None] * (len(shape) - len(base))
    if n_data > 1:
        for i, dim in enumerate(shape):
            if base[i] is None and dim % n_data == 0 and dim // n_data >= 1:
                base[i] = data_axis
                break
    while base and base[-1] is None:
        base.pop()
    return tuple(base)


@dataclass(frozen=True)
class Layout:
    """A torch parameter's JAX leaf: the leaf's shape and, for each of its
    axes, the torch dim that holds it (or ``HEAD``: the head index of a
    per-head tensor, ``head`` of ``heads``)."""

    jax_shape: tuple
    axes: tuple
    head: int = 0


def jax_layout(model: nn.Module) -> dict[str, Layout]:
    """The JAX leaf of every parameter of ``model`` (a DualVGR, or any of
    its modules), by the re-layout of ``utils/weights.py``."""
    from dualvgr_tpu_torch.models.encoders import BiLSTM
    from dualvgr_tpu_torch.models.graph import PunishGAT

    out: dict[str, Layout] = {}
    gat_heads = {}
    for name, m in model.named_modules():
        if isinstance(m, PunishGAT):
            for h in range(m.n_heads):
                gat_heads[f"{name}.attention_{h}" if name else f"attention_{h}"] = (h, m.n_heads)
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            shape = tuple(p.shape)
            owner = mname.rsplit(".", 1)[0] if "." in mname else ""
            if owner in gat_heads:  # attention_{h}.W / .a of a PunishGAT
                h, nh = gat_heads[owner]
                kind = mname.rsplit(".", 1)[1]
                if kind == "W" and pname == "weight":  # (hd, D) of w_kernel (D, H, hd)
                    out[name] = Layout((shape[1], nh, shape[0]), (1, HEAD, 0), h)
                elif kind == "W":  # (hd,) of w_bias (H, hd)
                    out[name] = Layout((nh, shape[0]), (HEAD, 0), h)
                elif pname == "weight":  # (1, 2hd) of a (H, 2hd)
                    out[name] = Layout((nh, shape[1]), (HEAD, 1), h)
                else:  # (1,) of a_bias (H,)
                    out[name] = Layout((nh,), (HEAD,), h)
            elif isinstance(m, (nn.Linear, BiLSTM)) and len(shape) == 2:
                out[name] = Layout((shape[1], shape[0]), (1, 0))
            else:  # biases, the embedding, a GCN weight, the batch norm: the same layout
                out[name] = Layout(shape, tuple(range(len(shape))))
    return out


def _torch_dim(layout: Layout, spec: tuple, axis_name: str):
    """The torch dim (or ``HEAD``) holding the JAX axis that ``spec`` shards
    over ``axis_name``; None when it shards none."""
    for i, a in enumerate(spec):
        if a == axis_name:
            return layout.axes[i]
    return None


@dataclass
class _Param:
    """One parameter under a placement: its name, the tensor, its TP dim
    (None: whole on every rank of the model axis) and, under ZeRO, its
    slice along the data axis: (dim, start, length), or ("owner", i) for a
    head held whole by the data rank i."""

    name: str
    param: nn.Parameter
    layout: Layout
    tp_dim: int | None = None
    zero: tuple | None = None


@dataclass
class Placement:
    """How a train state lies on a mesh: the data and model axes as this
    rank sees them, and every parameter's shard and slice."""

    mesh: object
    data: Axis
    model: Axis
    params: list = field(default_factory=list)
    state_keys: list = field(default_factory=list)
    zero: bool = False
    zero_slices: list = field(default_factory=list)
    buckets: object = None  # _GradBuckets when the data axis has several ranks

    @property
    def tp(self) -> bool:
        return self.model.size > 1

    def overlap_gradients(self, bucket_mb: float) -> None:
        """All-reduce the gradient over the data axis during the backward,
        in buckets of about ``bucket_mb`` MB (``_GradBuckets``; ``inf``: one
        bucket, launched when the backward ends)."""
        if self.data.size > 1:
            self.buckets = _GradBuckets([p.param for p in self.params], self.data, bucket_mb * 2**20)

    def before_backward(self) -> None:
        """Forget the buckets of a backward whose gradients were never
        reduced (an abandoned step)."""
        if self.buckets is not None:
            self.buckets.reset()

    def reduce_gradients(self, grads) -> None:
        """Sum ``grads`` over the data axis in place (each rank's loss is its
        share of the global loss): wait for the all-reduces the backward
        launched."""
        if self.buckets is not None and grads:
            self.buckets.reduce(grads)

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm of the whole (unsharded) gradient: the squares of
        the shards summed over the model axis, the whole ones counted once."""
        if not self.tp:
            return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        sq_whole = sum(g.square().sum() for g, p in zip(grads, self.params) if p.tp_dim is None)
        sq_shard = sum(g.square().sum() for g, p in zip(grads, self.params) if p.tp_dim is not None)
        return torch.sqrt(sq_whole + all_reduce_(sq_shard.clone(), self.model))

    def zero_step(self, adam) -> None:
        """One Adam step on this rank's slices (``adam`` runs over them),
        from the parameters' (all-reduced, clipped) ``.grad``; then every
        rank's updated slices are gathered into every parameter."""
        for p, sl in zip(self.params, self.zero_slices):
            sl.grad = _slice(p.param.grad, p.zero, self.data)
        adam.step()
        with torch.no_grad():
            for p, sl in zip(self.params, self.zero_slices):
                if p.zero is None:
                    continue
                if p.zero[0] == "owner":
                    src = dist.get_global_rank(self.data.group, p.zero[1])
                    broadcast_(p.param.data, src=src, group=self.data.group)
                else:
                    p.param.data.copy_(all_gather_cat(sl.data, self.data, p.zero[0]))


class _GradBuckets:
    """The gradient's all-reduce over the data axis, overlapped with the
    backward as ``DistributedDataParallel``'s buckets are. The parameters,
    in reverse order (about the order in which the backward finishes
    them), are cut into buckets of about ``cap`` bytes; a hook on each
    parameter counts its gradient in once it is accumulated, and a bucket
    whose gradients are all in is flattened and all-reduced asynchronously.
    Buckets are launched in index order, so every rank issues the same
    collectives in the same order. ``reduce`` launches what the backward
    left (a parameter with no gradient counts as zeros), waits for every
    bucket and copies the sums into the gradients."""

    def __init__(self, params, axis: Axis, cap: float):
        self.params, self.axis = params, axis
        self.buckets, cur, size = [], [], 0
        for i in reversed(range(len(params))):
            cur.append(i)
            size += params[i].numel() * params[i].element_size()
            if size >= cap:
                self.buckets.append(cur)
                cur, size = [], 0
        if cur:
            self.buckets.append(cur)
        self.bucket_of = {i: b for b, idx in enumerate(self.buckets) for i in idx}
        self.reset()
        for i, p in enumerate(params):
            p.register_post_accumulate_grad_hook(lambda _p, i=i: self._ready(i))

    def reset(self) -> None:
        for _, _, work in getattr(self, "works", []):
            work.wait()
        self.left = [len(idx) for idx in self.buckets]
        self.launched, self.works = 0, []

    def _ready(self, i: int) -> None:
        self.left[self.bucket_of[i]] -= 1
        while self.launched < len(self.buckets) and self.left[self.launched] == 0:
            self._launch()

    def _launch(self) -> None:
        b = self.launched
        grads = [self.params[i].grad if self.params[i].grad is not None else torch.zeros_like(self.params[i])
                 for i in self.buckets[b]]
        flat = _flatten_dense_tensors(grads)
        self.works.append((b, flat, dist.all_reduce(flat, group=self.axis.group, async_op=True)))
        self.launched += 1

    def reduce(self, grads) -> None:
        while self.launched < len(self.buckets):
            self._launch()
        for b, flat, work in self.works:
            work.wait()
            idx = self.buckets[b]
            for i, r in zip(idx, _unflatten_dense_tensors(flat, [grads[i] for i in idx])):
                grads[i].copy_(r)
        self.works = []
        self.reset()


def _slice(t, zero, data: Axis):
    """This data rank's slice of ``t`` under ``zero`` (a view)."""
    if zero is None:
        return t
    if zero[0] == "owner":
        return t if zero[1] == data.rank else t.narrow(0, 0, 0)
    dim, start, n = zero
    return t.narrow(dim, start, n)


class _Gathered(nn.Module):
    """Parametrization: the whole tensor, gathered along ``dim`` over the
    model axis from each rank's shard (the backward keeps the shard's)."""

    def __init__(self, axis: Axis, dim: int):
        super().__init__()
        self.axis, self.dim = axis, dim

    def forward(self, local):
        return gather_columns(local, self.axis, self.dim)


def _column_parallel(module: nn.Module, axis: Axis, *, takes_input_grad: bool = True) -> None:
    """Make ``module`` (a Linear or an Embedding whose weight holds this
    rank's output columns) give the whole output: its input's gradient
    summed over ``axis``, its output columns gathered over it."""
    inner = module.forward

    def forward(self, x):
        if takes_input_grad:
            x = copy_to_axis(x, axis)
        return gather_columns(inner(x), axis, -1)

    module.forward = types.MethodType(forward, module)


def _column_parallel_proj(axis: Axis):
    """A BiLSTM's input projection, column-parallel: (B, T, D) -> this
    rank's gate columns (T, B, 4H / tp), gathered to (T, B, 4H)."""
    from dualvgr_tpu_torch.ops.lstm import time_major_input_proj

    def proj(x, params, *, reverse: bool = False, stream_dtype=None):
        gates = time_major_input_proj(copy_to_axis(x, axis), params, reverse=reverse, stream_dtype=stream_dtype)
        return gather_columns(gates, axis, -1)

    return proj


def _module_of(model, name):
    mname, _, pname = name.rpartition(".")
    return (model.get_submodule(mname) if mname else model), pname


def _narrow(t, dim, axis: Axis):
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.rank * n, n)


def _placement(state, mesh, data_axis: str | None = None) -> Placement:
    from dualvgr_tpu_torch.parallel.mesh import mesh_axis

    names = mesh.mesh_dim_names
    data_axis = data_axis or names[0]
    model = state.model
    data = mesh_axis(mesh, data_axis)
    model_ax = mesh_axis(mesh, MODEL_AXIS) if MODEL_AXIS in names and MODEL_AXIS != data_axis else Axis(None, 0, 1)
    layouts = jax_layout(model)
    params = [_Param(n, p, layouts[n]) for n, p in model.named_parameters()]
    return Placement(mesh, data, model_ax, params, list(model.state_dict().keys()))


def _adam_over(params, old, lr, betas, eps):
    """An Adam over ``params`` whose state for each is ``old``'s entry for
    it (a dict, or None for no state yet)."""
    adam = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    for p, st in zip(params, old):
        if st:
            adam.state[p] = st
    return adam


def _adam_states(adam, params):
    return [dict(adam.state[p]) if p in adam.state else None for p in params]


def shard_state_tp(state, mesh):
    """Shard a train state over ``mesh``'s model axis by
    ``leaf_spec``: each sharded parameter (and its Adam moments and
    accumulated gradient) keeps this rank's shard, and the model computes
    on the shards (module docstring). Returns the state, with its
    ``placement``."""
    from torch.nn.utils import parametrize

    from dualvgr_tpu_torch.models.encoders import BiLSTM
    from dualvgr_tpu_torch.models.graph import _GATHead

    pl = state.placement if state.placement is not None else _placement(state, mesh)
    model = state.model
    ax = pl.model
    old = _adam_states(state.adam, [p.param for p in pl.params])
    for i, p in enumerate(pl.params):
        d = _torch_dim(p.layout, leaf_spec(p.layout.jax_shape, ax.size), MODEL_AXIS)
        if d == HEAD:
            raise NotImplementedError(f"{p.name}: the JAX rule shards its head axis, which the port holds as "
                                      "separate tensors")
        p.tp_dim = d
        if d is None or ax.size == 1:
            continue
        with torch.no_grad():
            p.param.data = _narrow(p.param.data, d, ax).clone()
        if old[i]:
            for k in ("exp_avg", "exp_avg_sq"):
                old[i][k] = _narrow(old[i][k], d, ax).clone()
        if state.acc_grads:
            state.acc_grads[i] = _narrow(state.acc_grads[i], d, ax).clone()
    if ax.size > 1:
        sharded = {p.name: p for p in pl.params if p.tp_dim is not None}
        consumed = set()
        # a GAT head's W and a are read merged by its bank, never called
        heads = {n for n, m in model.named_modules() if isinstance(m, _GATHead)}
        for mname, m in model.named_modules():
            pre = f"{mname}." if mname else ""
            if isinstance(m, BiLSTM):
                ih = [f"{pre}{k}_l0{s}" for s in ("", "_reverse") for k in ("weight_ih", "bias_ih", "bias_hh")]
                if all(k in sharded for k in ih):
                    m.input_proj = _column_parallel_proj(ax)
                    consumed.update(ih)
            elif isinstance(m, (nn.Linear, nn.Embedding)) and f"{pre}weight" in sharded and \
                    mname.rpartition(".")[0] not in heads:
                _column_parallel(m, ax, takes_input_grad=isinstance(m, nn.Linear))
                consumed.update(k for k in (f"{pre}weight", f"{pre}bias") if k in sharded)
        for name, p in sharded.items():
            if name not in consumed:
                mod, pname = _module_of(model, name)
                parametrize.register_parametrization(mod, pname, _Gathered(ax, p.tp_dim), unsafe=True)
    g = state.adam.param_groups[0]
    state.adam = _adam_over([p.param for p in pl.params], old, g["lr"], g["betas"], g["eps"])
    state.placement = pl
    return state


def shard_opt_state_zero(state, mesh, data_axis: str | None = None):
    """ZeRO-1 over the data axis: each rank keeps Adam's moments only for
    its slice of each parameter along the axis ``zero_leaf_spec`` names,
    and ``Placement.zero_step`` updates the slices and gathers them.
    Returns the state."""
    pl = state.placement if state.placement is not None else _placement(state, mesh, data_axis)
    data, n_model = pl.data, pl.model.size
    adam = state.adam
    old = _adam_states(adam, [p.param for p in pl.params])
    slices, sliced_old = [], []
    for p, st in zip(pl.params, old):
        spec = zero_leaf_spec(p.layout.jax_shape, data.size, n_model, data_axis=data.name)
        d = _torch_dim(p.layout, spec, data.name)
        if d is None or data.size == 1:
            p.zero = None
        elif d == HEAD:  # heads per data rank: the leaf's head count over the axis
            p.zero = ("owner", p.layout.head // (p.layout.jax_shape[spec.index(data.name)] // data.size))
        else:
            n = p.param.shape[d] // data.size
            p.zero = (d, data.rank * n, n)
        sl = p.param if p.zero is None else nn.Parameter(_slice(p.param.data, p.zero, data))
        slices.append(sl)
        if st:
            st = dict(st)
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = _slice(st[k], p.zero, data).clone()
        sliced_old.append(st)
    g = adam.param_groups[0]
    state.adam = _adam_over(slices, sliced_old, g["lr"], g["betas"], g["eps"])
    pl.zero, pl.zero_slices = True, slices
    state.placement = pl
    return state


def mesh_for(cfg, device="cuda"):
    """The mesh a driver runs on, from ``cfg.tpu``: a 1-D data mesh named
    ``mesh_axis`` when ``tensor_parallel`` is 1, else a (ranks / tp) x tp
    (data, model) mesh; None in a run with no process group (one process,
    nothing to place), where ``tensor_parallel > 1`` raises. A data axis
    named "model" is refused: the JAX package's ``place_state`` would take
    it for the model axis and shard the state over it."""
    from dualvgr_tpu_torch.parallel.mesh import data_mesh

    if cfg.tpu.mesh_axis == MODEL_AXIS:
        raise ValueError(f"tpu.mesh_axis={MODEL_AXIS!r} is the model axis's name; name the data axis otherwise")
    tp = int(cfg.tpu.get("tensor_parallel", 1))
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % tp:
        raise ValueError(f"tpu.tensor_parallel={tp} does not divide the {n} available devices")
    if not dist.is_initialized():
        return None
    dev = torch.device(device).type
    if tp <= 1:
        return data_mesh(cfg.tpu.mesh_axis, dev)
    return dp_tp_mesh(n // tp, tp, dev, data_axis=cfg.tpu.mesh_axis)


def place_state(state, mesh, *, zero_opt: bool = False, bucket_mb: float = BUCKET_MB):
    """Put a train state on ``mesh``:
    broadcast from rank 0 (``replicate``), TP-sharded when the mesh has a
    model axis, its optimizer state ZeRO-sharded over the data axis with
    ``zero_opt``; its dropout sites and batch norm take the data axis
    (global-batch masks and statistics); its gradient all-reduced during
    the backward in buckets of ``bucket_mb`` MB (``inf``: one bucket,
    launched when the backward ends). ``mesh`` None (one process) leaves
    it as it is. Returns the state."""
    from dualvgr_tpu_torch.models.decoder import MaskedBatchNorm
    from dualvgr_tpu_torch.ops.dropout import Dropout
    from dualvgr_tpu_torch.parallel.mesh import replicate

    if mesh is None:
        return state
    replicate(state, mesh)
    state.placement = pl = _placement(state, mesh)
    if pl.model.size > 1:
        shard_state_tp(state, mesh)
    if zero_opt:
        shard_opt_state_zero(state, mesh)
    pl.overlap_gradients(bucket_mb)
    for m in state.model.modules():
        if isinstance(m, (Dropout, MaskedBatchNorm)):
            m.axis = pl.data
    return state


def _dtensor(local, mesh, pl: Placement, tp_dim, zero):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = []
    for name in mesh.mesh_dim_names:
        if name == MODEL_AXIS and pl.model.size > 1 and tp_dim is not None:
            placements.append(Shard(tp_dim))
        elif name == pl.data.name and zero is not None and zero[0] != "owner":
            placements.append(Shard(zero[0]))
        else:
            placements.append(Replicate())
    return DTensor.from_local(local, mesh, placements, run_check=False)


def state_dtensors(state) -> dict:
    """The state at rest as DTensors: ``params/<name>`` for each parameter
    (Shard on the model axis where TP shards it), ``exp_avg/<name>`` and
    ``exp_avg_sq/<name>`` for Adam's moments (also Shard on the data axis
    under ZeRO). A head's moments held whole by one data rank are not a
    DTensor shard; they are listed as this rank's plain tensors. No
    communication: each DTensor wraps this rank's memory."""
    pl = state.placement
    out = {}
    for p in pl.params:
        out[f"params/{p.name}"] = _dtensor(p.param.data, pl.mesh, pl, p.tp_dim, None)
    slices = pl.zero_slices if pl.zero else [p.param for p in pl.params]
    for p, sl in zip(pl.params, slices):
        st = state.adam.state.get(sl, {})
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                out[f"{k}/{p.name}"] = (st[k] if p.zero is not None and p.zero[0] == "owner"
                                        else _dtensor(st[k], pl.mesh, pl, p.tp_dim, p.zero))
    return out


def tp_sharded_leaf_count(tree, mesh) -> int:
    """How many leaves of ``tree`` (a dict of tensors, such as
    ``state_dtensors``, or a placed train state) are split over the model
    axis: >0 certifies that TP is engaged, not silently DP."""
    from torch.distributed.tensor import DTensor, Shard

    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return 0
    if hasattr(tree, "placement"):
        tree = state_dtensors(tree)
    dim = mesh.mesh_dim_names.index(MODEL_AXIS)
    if mesh.size(dim) <= 1:
        return 0
    return sum(1 for v in tree.values()
               if isinstance(v, DTensor) and isinstance(v.placements[dim], Shard))


def state_bytes(state) -> int:
    """Bytes this rank holds of the parameters and Adam's moments."""
    pl = state.placement
    params = [p.param for p in pl.params] if pl is not None else list(state.model.parameters())
    slices = pl.zero_slices if pl is not None and pl.zero else params
    n = sum(p.numel() * p.element_size() for p in params)
    for sl in slices:
        for k in ("exp_avg", "exp_avg_sq"):
            t = state.adam.state.get(sl, {}).get(k)
            if t is not None:
                n += t.numel() * t.element_size()
    return n


def _full(t, p: _Param, pl: Placement, *, zero: bool):
    """The whole tensor of parameter ``p``'s shape from this rank's piece
    ``t`` (a ZeRO slice with ``zero``, then a TP shard); collective."""
    if zero and p.zero is not None:
        if p.zero[0] == "owner":
            buf = t if t.numel() else torch.zeros(p.param.shape, dtype=t.dtype, device=t.device)
            t = broadcast_(buf.clone(), src=dist.get_global_rank(pl.data.group, p.zero[1]), group=pl.data.group)
        else:
            t = all_gather_cat(t, pl.data, p.zero[0])
    if p.tp_dim is not None and pl.model.size > 1:
        t = all_gather_cat(t, pl.model, p.tp_dim)
    return t


def full_state_dicts(state) -> tuple[dict, dict, list]:
    """The unsharded (model state_dict in the reference's key names, Adam
    state_dict as a one-process Adam over ``model.parameters()`` gives it,
    accumulated gradients) of a placed train state; collective: every rank
    of the mesh calls it."""
    pl = state.placement
    model = state.model
    with torch.no_grad():
        whole = {p.name: _full(p.param.data, p, pl, zero=False) for p in pl.params}
        buffers = dict(model.named_buffers())
        sd = {k: (whole[k] if k in whole else buffers[k]).detach() for k in pl.state_keys}
        opt = state.adam.state_dict()
        for i, p in enumerate(pl.params):
            st = opt["state"].get(i)
            if st is None:
                continue
            st = opt["state"][i] = dict(st)  # the packed dicts are Adam's own
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = _full(st[k], p, pl, zero=pl.zero)
        acc = [_full(a, p, pl, zero=False) for a, p in zip(state.acc_grads, pl.params)]
    return sd, opt, acc
