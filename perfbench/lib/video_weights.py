"""The backbones' weights, made from the seed on the device in one uniform
draw, each leaf scaled by its rule; ``weights.py``'s rules are DualVGR's.

The published checkpoints are not here, and a 100-layer residual net from
an arbitrary draw can grow without bound through its 33 bottlenecks. So:

* every conv takes He's uniform bound on its fan-in, sqrt(6 / fan_in)
  (a grouped conv's fan-in is its group's), which keeps a ReLU net's
  second moment from layer to layer;
* a bottleneck's last batch norm scales by 0.2 (+-0.05): each block adds
  a small share to the residual stream, which then grows by a few percent
  a block and not by a factor;
* the motion backbone's stem is scaled down by ``RAW_PIXEL_RMS``, the rms
  of a uniform 0-255 pixel, because it reads raw pixels where the
  appearance backbone reads normalised ones;
* the other batch norms scale by 1 (+-0.05), and their shifts, running
  means and (above 1) running variances are drawn small and non-zero, so
  that a path that drops one of them shows in the comparison.

The pooled features then come out between about 0.1 and 10 at every
seed (``perfbench/tests/test_perfbench_video.py``).
"""

from __future__ import annotations

import math

import torch

from perfbench.lib.common import sub_seed

RAW_PIXEL_RMS = 147.0  # sqrt(mean of p^2) for p uniform on 0..255
LAST_BN_SCALE = 0.2


def make_backbone_weights(spec: dict, seed: int, tag: str, device, raw_input: bool = False) -> dict:
    """``{key: tensor}`` for every key of ``spec`` (the reference's
    ``resnet101_spec`` or ``resnext101_spec``) from ``seed``; ``tag`` names
    the backbone, so that the two draw apart; ``raw_input`` for the
    backbone that reads raw 0-255 pixels."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, f"backbone.{tag}"))
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
            if len(shape) > 1:  # a conv
                scale = math.sqrt(6.0 / math.prod(shape[1:]))
                if key == "conv1.weight" and raw_input:
                    scale /= RAW_PIXEL_RMS
                out[key] = u * scale
            elif key.endswith("running_var"):
                out[key] = 1.0 + 0.25 * (u + 1)
            elif key.endswith(".bn3.weight"):
                out[key] = LAST_BN_SCALE + 0.05 * u
            elif key.endswith(".weight"):  # the other batch norms' scales
                out[key] = 1.0 + 0.05 * u
            else:  # shifts and running means
                out[key] = 0.05 * u
    return out
