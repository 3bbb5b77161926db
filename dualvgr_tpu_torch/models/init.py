"""Initializers matching the reference's post-construction init pass.

The reference re-initializes every Linear/LSTM weight with xavier_uniform
and zeroes every bias after building the model (reference models.py:52,
model/utils.py:8-33); the embedding is U(-1, 1) (models.py:53). The port's
parameters already have the reference's torch shapes (out, in), so the fans
are read off the shape. Every draw takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ on a 2-D (out, in) weight."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def init_dualvgr_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference init over every parameter, in registration order:
    embeddings U(-1, 1), matrices xavier_uniform, vectors zero (biases, and
    the batch-norm shift); the batch-norm scale is one."""
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, nn.Embedding):
                    p.uniform_(-1.0, 1.0, generator=generator)
                elif p.ndim == 2:
                    xavier_uniform_(p, generator)
                elif name == "weight":  # batch-norm scale
                    p.fill_(1.0)
                else:
                    p.zero_()
    return model
