"""Device meshes and batch placement: the distributed-communication layer.

The port's counterpart of the JAX package's ``parallel/mesh.py``, in
PyTorch's idiom: one process per GPU (one rank), a ``torch.distributed``
process group over the ranks, and a ``DeviceMesh`` naming its axes.
Semantics are global-batch, as in the JAX package: a train step over a
batch split across the data axis computes what one process computes on
the whole batch, batch-norm statistics, loss normalization and dropout
masks included (``train_lib``, ``models/decoder.py::MaskedBatchNorm``,
``ops/dropout.py``).

* ``maybe_initialize_distributed`` brings the group up from the
  environment ``torchrun`` sets (NCCL on CUDA, gloo on the CPU) and binds
  ``cuda:LOCAL_RANK``;
* ``data_mesh`` is the 1-D mesh over every rank, named by
  ``tpu.mesh_axis``; ``batch_sharding`` / ``replicated_sharding`` are the
  DTensor placements of a batch (``Shard(0)`` on the data axis) and of the
  state (``Replicate()``);
* ``replicate`` broadcasts a train state from rank 0 (after a restore on
  rank 0);
* ``process_batch_bounds`` is this rank's rows ``[r B/W, (r+1) B/W)`` of a
  global batch, ``shard_batch`` takes them from a global batch and
  ``shard_batch_local`` takes a batch whose rows are already this rank's
  (host-sharded loading, ``data/loader.py``);
* ``prefetch_to_device`` copies batches to the device ahead of use, a
  host-sharded loader's local batches with ``local=True``.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch
import torch.distributed as dist

from dualvgr_tpu_torch.parallel.comm import Axis, broadcast_
from dualvgr_tpu_torch.utils.trace import count, is_on, span

# the environment a launcher (torchrun) sets for every rank
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def maybe_initialize_distributed(device="cuda") -> bool:
    """Bring up the default process group from a launcher's environment:
    NCCL for a CUDA ``device`` (bound to ``cuda:LOCAL_RANK`` first), gloo
    for the CPU. Returns False, and does nothing, when no launcher set
    ``WORLD_SIZE`` and ``RANK``; True when the group is up, also when it
    already was (safe to call twice)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was launched on a machine where torch.cuda.is_available() is False")
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", init_method="env://", device_id=local)
    else:
        dist.init_process_group("gloo", init_method="env://")
    return True


def data_mesh(axis_name: str = "data", device_type: str = "cuda"):
    """1-D data-parallel mesh over every rank of the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def mesh_axis(mesh, axis_name: str) -> Axis:
    """``axis_name`` of ``mesh`` as this rank sees it (its group, this
    rank's index along it, its size)."""
    dim = mesh.mesh_dim_names.index(axis_name)
    return Axis(mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim), axis_name)


def batch_sharding(mesh, axis_name: str = "data"):
    """The placements of a batch: its leading (batch) axis sharded over
    ``axis_name``, replicated over the mesh's other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if n == axis_name else Replicate() for n in mesh.mesh_dim_names)


def replicated_sharding(mesh):
    """The placements of a fully replicated tensor (params, optimizer state)."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def replicate(state, mesh=None):
    """Broadcast a train state from rank 0 to every rank, in place: its
    model's parameters and buffers, the accumulated gradients, Adam's
    state, the dropout generator and the counts. Needed after a restore on
    rank 0 alone. Returns the state."""
    del mesh  # every rank of the default group takes part
    if dist.get_world_size() == 1:
        return state
    with torch.no_grad():
        for t in [*state.model.state_dict().values(), *state.acc_grads]:
            broadcast_(t, src=0)
    from dualvgr_tpu_torch.utils.checkpoint import to_cpu

    rank0 = dist.get_rank() == 0
    box = [dict(step=state.step, updates=state.updates, mini_step=state.mini_step,
                generator=state.generator.get_state(),
                adam=to_cpu(state.adam.state_dict()) if state.adam.state else None) if rank0 else None]
    dist.broadcast_object_list(box, src=0)
    got = box[0]
    state.step, state.updates, state.mini_step = got["step"], got["updates"], got["mini_step"]
    state.generator.set_state(got["generator"])
    if got["adam"] is not None and not rank0:
        state.adam.load_state_dict(got["adam"])
    return state


def process_batch_bounds(mesh, axis_name: str, global_batch: int) -> tuple[int, int]:
    """(start, stop): the rows of a global batch of ``global_batch`` that
    this rank holds under the batch sharding, ``[r B/W, (r+1) B/W)`` for
    this rank's index r along ``axis_name`` of size W; what a host-sharded
    loader gathers. Raises ValueError when W does not divide the batch."""
    if mesh is None:
        return 0, global_batch
    ax = mesh_axis(mesh, axis_name)
    return batch_bounds(ax.rank, ax.size, global_batch)


def batch_bounds(index: int, size: int, global_batch: int) -> tuple[int, int]:
    """(start, stop) of block ``index`` of ``size`` equal blocks of a global
    batch: the rows the batch sharding gives the ``index``-th device of a
    data axis of ``size``. Raises ValueError when ``size`` does not divide
    the batch, as the sharding does."""
    if global_batch % size:
        raise ValueError(f"a global batch of {global_batch} rows does not split evenly over a data axis of "
                         f"{size}")
    per = global_batch // size
    return index * per, (index + 1) * per


def shard_batch(batch, mesh, axis_name: str = "data"):
    """This rank's rows of a global batch (tuples and lists of tensors and
    numpy arrays, every leaf with the batch on its leading axis; arrays
    come back as tensors, other leaves kept). Raises ValueError when the mesh axis does not divide the
    batch; the loader pads the final partial batch so that it does."""
    if mesh is None:
        return batch
    sizes = {int(t.shape[0]) for t in _leaves(batch)}
    if len(sizes) != 1:
        raise ValueError(f"the leaves of a batch differ in their leading dim: {sorted(sizes)}")
    lo, hi = process_batch_bounds(mesh, axis_name, sizes.pop())
    return _map_tensors(batch, lambda x: x[lo:hi])


def shard_batch_local(batch, mesh, axis_name: str = "data"):
    """A batch whose rows are already this rank's (``process_batch_bounds``
    of the global batch, gathered by a host-sharded loader), as it is: the
    counterpart of the JAX package's placement from per-process data, which
    in one process per rank has nothing left to move. Raises ValueError if
    its leaves differ in their leading dim."""
    del mesh, axis_name
    sizes = {int(t.shape[0]) for t in _leaves(batch)}
    if len(sizes) > 1:
        raise ValueError(f"the leaves of a batch differ in their leading dim: {sorted(sizes)}")
    return batch


def _leaves(obj):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _leaves(x)


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to every tensor and numpy array in it,
    through tuples (named ones too) and lists; other leaves kept."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, np.ndarray):
        return fn(torch.from_numpy(obj))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(x, fn) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(x, fn) for x in obj)
    return obj


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


def prefetch_to_device(iterator, device="cuda", size: int = 2, *, local: bool = False):
    """Yield the items of ``iterator`` with every tensor and numpy array in
    them (through tuples and lists) on ``device``, keeping ``size`` items'
    copies in flight ahead of the consumer. With ``local=True`` each item
    holds this rank's rows of a global batch already (a host-sharded
    loader; ``shard_batch_local``).

    On a CUDA device each item's copies are issued with
    ``non_blocking=True`` on a side stream, so they overlap the work on the
    current (compute) stream, which waits on the item's event before the
    item is handed out. Tensors and arrays in pageable memory (the small
    fields of a batch) are pinned first: a copy from pageable memory waits
    for the side stream's earlier copies, and the host with it. A copy from
    pinned memory is asynchronous: torch's pinned-memory allocator records
    the copy on the block and does not give the block out again before the
    copy is done, so a pinned batch the loader has let go of is never
    rewritten under its copy. The device tensors are made on the side
    stream and used on the compute stream: ``record_stream`` keeps their
    memory from being reused before the compute stream's work on them is
    done. On another device, a pass-through.
    """
    if local:
        iterator = (shard_batch_local(b, None) for b in iterator)
    dev = torch.device(device)
    if dev.type != "cuda":
        yield from iterator
        return
    compute = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    buf = collections.deque()
    it = iter(iterator)

    def copy(t):
        pinned = t.is_pinned()
        if is_on():
            count("prefetch.bytes", t.nbytes)
            count("prefetch.pinned", not pinned)
        return (t if pinned else t.pin_memory()).to(dev, non_blocking=True)

    def enqueue() -> bool:
        try:
            item = next(it)
        except StopIteration:
            return False
        with span("prefetch.copy"), torch.cuda.stream(side):
            moved = _map_tensors(item, copy)
            done = torch.cuda.Event()
            done.record(side)
        buf.append((moved, done))
        return True

    for _ in range(max(size, 1)):
        if not enqueue():
            break
    while buf:
        moved, done = buf.popleft()
        compute.wait_event(done)
        for t in _tensors(moved):
            t.record_stream(compute)
        enqueue()
        yield moved
