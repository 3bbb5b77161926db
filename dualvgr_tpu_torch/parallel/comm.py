"""The collectives under the port's multi-device path.

Everything the data-parallel step, tensor parallelism and ZeRO-1 need is
built on three collectives of ``torch.distributed``: ``all_reduce`` (sum),
``broadcast`` and ``all_gather``, on tensors where the state lies. Gloo
has all three for CPU and CUDA tensors, NCCL for CUDA tensors, so the same
code runs under either backend (two ranks sharing one card can only use
gloo: NCCL refuses two ranks on one device).

An ``Axis`` is one axis of the mesh as this rank sees it: the process
group of the ranks that share this rank's other coordinates, this rank's
index along the axis and the axis's size. The autograd functions below
take one:

* ``all_reduce_sum``: the sum over the axis, whose backward is the same sum
  of the cotangents (each rank's loss is one term of the global loss). It
  is what ``torch.distributed.nn.functional.all_reduce`` computes, kept
  here because that function warns on every call that it is deprecated
  (torch 2.13), and the successor it names
  (``torch.distributed._functional_collectives``) is a private module;
* ``gather_columns``: ``all_gather`` along a dim, whose backward keeps this
  rank's chunk of the cotangent (what follows the gather is computed alike
  on every rank of the axis, so each holds the whole cotangent already);
* ``copy_to_axis``: the identity, whose backward sums the cotangent over
  the axis (the input of a column-parallel product, each rank of which
  gives only its columns' share of the input's gradient).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Axis:
    """One mesh axis seen from this rank: its process group, this rank's
    index along it and its size."""

    group: object
    rank: int
    size: int
    name: str = ""


def all_reduce_(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum ``t`` over ``axis`` in place and return it."""
    if axis.size > 1:
        dist.all_reduce(t, group=axis.group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Overwrite ``t`` with global rank ``src``'s ``t`` and return it."""
    dist.broadcast(t, src=src, group=group)
    return t


def all_gather_cat(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in rank
    order (each rank's ``t`` has the same shape)."""
    if axis.size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None, None


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis), None


def all_reduce_sum(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (differentiable); ``x`` without one."""
    if axis is None or axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def gather_columns(x: torch.Tensor, axis: Axis, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated along ``dim``
    (differentiable; the backward keeps this rank's chunk)."""
    if axis.size == 1:
        return x
    return _GatherColumns.apply(x, axis, dim % x.dim())


def copy_to_axis(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x``, whose gradient is summed over ``axis`` in the backward."""
    if axis.size == 1:
        return x
    return _CopyToAxis.apply(x, axis)
