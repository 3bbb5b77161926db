"""Initializers matching the reference's post-construction init pass.

The reference re-initializes every Linear/LSTM weight with xavier_uniform
and zeroes every bias after building the model (reference models.py:52,
model/utils.py:8-33); the embedding is U(-1, 1) (models.py:53). The port's
parameters already have the reference's torch shapes (out, in), so the fans
are read off the shape. Every draw takes an explicit ``torch.Generator``.
A GCN layer's (in, out) weight keeps its own uniform(-1/sqrt(out),
1/sqrt(out)) init (reference GraphNN.py:9-46), as in the JAX package.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from dualvgr_tpu_torch.models.graph import GraphConvolution


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ on a 2-D (out, in) weight."""
    fan_out, fan_in = w.shape
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return w.uniform_(-bound, bound, generator=generator)


def init_dualvgr_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference init over every parameter, in registration order:
    embeddings U(-1, 1), matrices xavier_uniform, vectors zero (biases, and
    the batch-norm shift); the batch-norm scale is one; GCN layers their
    own uniform init."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, GraphConvolution):
                mod.reset_parameters(generator)
                continue
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


def flax_init_(w: torch.Tensor, init: str, fan_in: int, fan_out: int) -> torch.Tensor:
    """A flax initializer on ``w`` with the fans flax computes for it:
    "xavier" (xavier_uniform), "xavier_normal", "lecun" (lecun_normal, a
    normal truncated at two deviations) or "torch" (leave torch's own)."""
    with torch.no_grad():
        if init == "xavier":
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            return w.uniform_(-bound, bound)
        if init == "xavier_normal":
            return w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)))
        if init == "lecun":
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978  # the truncation's correction
            return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)
        if init != "torch":
            raise ValueError(f"unknown init {init!r}")
        return w


def dense(in_dim: int, out_dim: int, bias: bool = True, init: str = "lecun") -> nn.Linear:
    """The counterpart of a flax ``nn.Dense``: an ``nn.Linear`` whose weight
    has flax's ``init`` (lecun_normal by default, as flax's) and whose bias
    is zero."""
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    flax_init_(lin.weight, init, in_dim, out_dim)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin
