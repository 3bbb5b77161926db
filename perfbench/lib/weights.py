"""Weights made from the seed on the device, in a few large calls: one
uniform draw for every parameter, then each leaf scaled by its rule.

Matrices take the published init's xavier-uniform bound, the word
embedding U(-1, 1). Biases and the batch norm's statistics, which the
published init sets to constants, are drawn small and non-zero, so that a
path that drops one of them shows in the comparison.
"""

from __future__ import annotations

import math

import torch

from perfbench.lib.common import sub_seed
from perfbench.reference.dualvgr import is_buffer, xavier_bound


def make_weights(spec: dict, seed: int, device) -> dict:
    """``{key: tensor}`` for every key of ``spec`` (the reference's ``param_spec``)."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    sizes = {k: math.prod(s) for k, s in spec.items() if not k.endswith("num_batches_tracked")}
    flat = torch.rand(sum(sizes.values()), generator=gen, device=device) * 2 - 1  # U(-1, 1)
    out, at = {}, 0
    with torch.no_grad():
        for key, shape in spec.items():
            if key.endswith("num_batches_tracked"):
                out[key] = torch.zeros((), dtype=torch.long, device=device)
                continue
            u = flat[at: at + sizes[key]].view(shape)
            at += sizes[key]
            if key.endswith("encoder_embed.weight"):
                out[key] = u
            elif len(shape) == 2:
                out[key] = u * xavier_bound(shape)
            elif key.endswith("running_var"):
                out[key] = 1.0 + 0.25 * (u + 1)
            elif key.endswith("classifier.3.weight"):
                out[key] = 1.0 + 0.05 * u
            else:  # biases, the batch norm's shift and running mean
                out[key] = 0.05 * u
    return out


def parameters(weights: dict) -> dict:
    """The trainable leaves of ``weights`` (buffers left out)."""
    return {k: v for k, v in weights.items() if not is_buffer(k)}
