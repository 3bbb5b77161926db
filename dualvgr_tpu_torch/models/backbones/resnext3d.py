"""3D ResNeXt-101 (Kinetics) — the motion backbone.

The port's counterpart of the JAX package's ``models/backbones/
resnext3d.py``, after the reference's Kinetics 3D-ResNets zoo (reference
preprocess/models/resnext.py:30-138): ResNeXtBottleneck with expansion 2
and cardinality 32, layers (3, 4, 23, 3), a 7^3 stem conv with stride
(1, 2, 2), a 3^3 max pool with stride 2, stage planes 128/256/512/1024,
type-B (projection) shortcuts and a global average pool; the output is the
pooled 2048-d feature the reference extracts (``last_fc=False``,
preprocess_features.py:31-41, 182-186). Inference path in NCDHW with the
Kinetics checkpoint's key names (``port_resnext101_state_dict`` strips
DataParallel's ``module.``).

The JAX package lowers two convs differently for the TPU (a block-diagonal
dense form of the grouped conv, space- and time-to-depth folds of the
stem). Those are TPU lowerings, not semantics: here the stem is the plain
7x7x7 conv, and the grouped 3x3x3 conv is cuDNN's grouped conv
(``impl="grouped"``) or a dense conv with the block-diagonal weight
(``impl="blockdiag"``: G times the multiply-adds on zeros, the same
result); ``impl="auto"`` takes the one ``BLOCKDIAG_SHAPES`` lists as
faster on the H100 for the conv's (compute dtype, channels, stride).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.models.backbones.resnet2d import TypedBatchNorm, TypedConv, compute_dtype_of

# (compute dtype, channels, stride) of the grouped convs that run faster
# as a dense conv with the block-diagonal weight on the H100 (channels-last,
# the flagship's 16 x 112^2 clips), from ``bench/extraction_bench.py
# --grouped-ab`` and chip_smoke.py's phase ``extract`` (PERF.md §5): in
# bf16 the tensor cores take G times the multiply-adds on zeros faster than
# cuDNN's grouped path at 4 and 8 channels a group (layer1, layer2's first
# block); in fp32 the grouped conv wins at every shape
BLOCKDIAG_SHAPES: frozenset = frozenset({("bfloat16", 128, 1), ("bfloat16", 256, 2)})


def blockdiag_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped conv weight (C_out, C_in/G, *k) as the dense (C_out, C_in,
    *k) weight that is zero off the G diagonal blocks."""
    c_out, w_in, *k = w.shape
    wg = w.reshape(groups, c_out // groups, w_in, -1)
    eye = torch.eye(groups, dtype=w.dtype, device=w.device)
    dense = torch.einsum("gh,goik->gohik", eye, wg)  # (G, w_out, G, w_in, K)
    return dense.reshape(c_out, groups * w_in, *k)


class GroupedConv3D(TypedConv):
    """The cardinality-G 3x3x3 conv (the weight in ``nn.Conv3d(groups=G)``'s
    shape and key)."""

    def __init__(self, channels: int, groups: int = 32, stride: int = 1, impl: str = "auto"):
        super().__init__(channels, channels, 3, stride=stride, padding=1, groups=groups, dims=3)
        if impl not in ("auto", "grouped", "blockdiag"):
            raise ValueError(f"impl must be auto, grouped or blockdiag, got {impl!r}")
        self.impl = impl

    def resolved_impl(self, dtype: torch.dtype = torch.float32) -> str:
        if self.impl != "auto":
            return self.impl
        key = (str(dtype).removeprefix("torch."), self.weight.shape[0], self.stride[0])
        return "blockdiag" if key in BLOCKDIAG_SHAPES else "grouped"

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.resolved_impl(x.dtype) == "blockdiag":
            return F.conv3d(x, blockdiag_weight(w, self.groups), None, self.stride, self.padding)
        return F.conv3d(x, w, None, self.stride, self.padding, 1, self.groups)


class ResNeXtBottleneck3D(nn.Module):
    """1x1x1 -> grouped 3x3x3 (stride here) -> 1x1x1, expansion 2."""

    def __init__(self, inplanes: int, planes: int, cardinality: int = 32, stride: int = 1,
                 downsample: bool = False, conv2_impl: str = "auto"):
        super().__init__()
        mid = cardinality * (planes // 32)
        self.conv1 = TypedConv(inplanes, mid, 1, dims=3)
        self.bn1 = TypedBatchNorm(mid)
        self.conv2 = GroupedConv3D(mid, cardinality, stride, conv2_impl)
        self.bn2 = TypedBatchNorm(mid)
        self.conv3 = TypedConv(mid, planes * 2, 1, dims=3)
        self.bn3 = TypedBatchNorm(planes * 2)
        self.downsample = (nn.Sequential(TypedConv(inplanes, planes * 2, 1, stride=stride, dims=3),
                                         TypedBatchNorm(planes * 2)) if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class ResNeXt101_3D(nn.Module):
    """(B, 3, T, H, W) float -> (B, C) fp32 (C = 2048 with all four stages).

    ``max_stages`` truncates after the stem (0) or stage N in {1..4}, as in
    the JAX package (a benchmark's per-stage cost); 4 = the full network.
    ``compute_dtype`` as in ``ResNet101``.
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), cardinality: int = 32, max_stages: int = 4,
                 compute_dtype: str = "float32", conv2_impl: str = "auto"):
        super().__init__()
        compute_dtype_of(compute_dtype)
        self.compute_dtype = compute_dtype
        self.conv1 = TypedConv(3, 64, 7, stride=(1, 2, 2), padding=3, dims=3)
        self.bn1 = TypedBatchNorm(64)
        inplanes = 64
        self.num_stages = min(max_stages, len(layers))
        for stage, (planes, n) in enumerate(zip((128, 256, 512, 1024), layers)):
            if stage >= self.num_stages:
                break
            blocks = []
            for block in range(n):
                stride = 2 if (stage > 0 and block == 0) else 1
                downsample = block == 0 and (stride != 1 or inplanes != planes * 2)
                blocks.append(ResNeXtBottleneck3D(inplanes, planes, cardinality, stride, downsample, conv2_impl))
                inplanes = planes * 2
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        y = x.to(compute_dtype_of(self.compute_dtype))
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool3d(y, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            y = getattr(self, f"layer{stage + 1}")(y)
        # fp32 pool reduction and output whatever the compute dtype
        return y.float().mean(dim=(2, 3, 4))


def port_resnext101_state_dict(sd: dict) -> dict:
    """A Kinetics resnext-101 state_dict (optionally ``module.``-prefixed by
    nn.DataParallel; tensors or numpy) -> the port's: the prefix stripped,
    the classifier's ``fc.*`` dropped, as tensors."""
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("fc."):
            out[k] = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return out
