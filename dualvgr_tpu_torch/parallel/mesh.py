"""Placing batches on the device.

The port's counterpart of the JAX package's ``parallel/mesh.py``. So far it
holds the one-device form of ``prefetch_to_device`` (the JAX package's
``mesh.py:154``); the data-parallel mesh belongs to multi-device, not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import collections

import numpy as np
import torch


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


def prefetch_to_device(iterator, device="cuda", size: int = 2):
    """Yield the items of ``iterator`` with every tensor and numpy array in
    them (through tuples and lists) on ``device``, keeping ``size`` items'
    copies in flight ahead of the consumer.

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
    dev = torch.device(device)
    if dev.type != "cuda":
        yield from iterator
        return
    compute = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    buf = collections.deque()
    it = iter(iterator)

    def copy(t):
        return (t if t.is_pinned() else t.pin_memory()).to(dev, non_blocking=True)

    def enqueue() -> bool:
        try:
            item = next(it)
        except StopIteration:
            return False
        with torch.cuda.stream(side):
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
