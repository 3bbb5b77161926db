"""Dropout that draws from an explicit generator.

The counterpart of flax ``nn.Dropout``: keep each element with probability
``1 - p`` and scale the kept ones by ``1 / (1 - p)``. ``F.dropout`` takes no
generator, so a train step could not be replayed from a seed; here every
draw comes from the ``torch.Generator`` the caller passes, on the tensor's
device. The JAX package's random bits are not reproduced: the two
frameworks' generators differ, and the tests compare distributions or run
with p = 0.

Under data parallelism the masks do not depend on how the batch is split,
as the JAX package's do not: a ``Dropout`` given the data axis
(``axis``, set by ``parallel.tp.place_state``) draws the mask of the whole
global batch from the generator every rank holds in the same state, and
keeps this rank's block of rows along ``batch_dim``. Every rank then draws
what one process draws on the global batch, and uses its own rows of it;
the draw costs the global batch's random numbers on every rank.
"""

from __future__ import annotations

import torch
from torch import nn


def dropout(x, p: float, *, generator: torch.Generator | None, training: bool, axis=None,
            batch_dim: int = 0):
    """``x`` with each element zeroed with probability ``p`` and the rest
    scaled by ``1 / (1 - p)``; ``x`` itself when not training or p == 0.
    With ``axis`` (a ``parallel.comm.Axis``, the data axis), ``x`` is this
    rank's block of ``axis.size`` equal blocks along ``batch_dim``, and the
    mask is this rank's block of the global batch's mask."""
    if not training or p == 0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws from an explicit torch.Generator; none was given")
    if p >= 1:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None and axis.size > 1:
        shape[batch_dim] *= axis.size
    keep = torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype) < 1.0 - p
    if axis is not None and axis.size > 1:
        n = x.shape[batch_dim]
        keep = keep.narrow(batch_dim, axis.rank * n, n)
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Dropout(nn.Module):
    """``dropout`` at rate ``p`` in the module's training mode, drawing from
    the generator passed to ``forward``. Without a generator it is the
    identity, as flax's ``deterministic=True`` (a module used on its own);
    ``DualVGR``'s training forward always passes one. It has no parameters
    or buffers, so it leaves the state_dict as it is. ``axis`` is the data
    axis under data parallelism (None in one process); ``batch_dim`` the
    dim of ``x`` that holds the batch's rows."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.axis = None

    def forward(self, x, generator: torch.Generator | None = None, batch_dim: int = 0):
        return dropout(x, self.p, generator=generator, training=self.training and generator is not None,
                       axis=self.axis, batch_dim=batch_dim)

    def extra_repr(self) -> str:
        return f"p={self.p}"
