"""Dropout that draws from an explicit generator.

The counterpart of flax ``nn.Dropout``: keep each element with probability
``1 - p`` and scale the kept ones by ``1 / (1 - p)``. ``F.dropout`` takes no
generator, so a train step could not be replayed from a seed; here every
draw comes from the ``torch.Generator`` the caller passes, on the tensor's
device. The JAX package's random bits are not reproduced: the two
frameworks' generators differ, and the tests compare distributions or run
with p = 0.
"""

from __future__ import annotations

import torch
from torch import nn


def dropout(x, p: float, *, generator: torch.Generator | None, training: bool):
    """``x`` with each element zeroed with probability ``p`` and the rest
    scaled by ``1 / (1 - p)``; ``x`` itself when not training or p == 0."""
    if not training or p == 0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws from an explicit torch.Generator; none was given")
    if p >= 1:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class Dropout(nn.Module):
    """``dropout`` at rate ``p`` in the module's training mode, drawing from
    the generator passed to ``forward``. Without a generator it is the
    identity, as flax's ``deterministic=True`` (a module used on its own);
    ``DualVGR``'s training forward always passes one. It has no parameters
    or buffers, so it leaves the state_dict as it is."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generator: torch.Generator | None = None):
        return dropout(x, self.p, generator=generator, training=self.training and generator is not None)

    def extra_repr(self) -> str:
        return f"p={self.p}"
