"""ResNet-101 (torchvision V1 architecture) — the appearance backbone.

The port's counterpart of the JAX package's ``models/backbones/
resnet2d.py``. The reference extracts per-frame appearance features with
torchvision's pretrained ResNet-101, FC stripped, output (B, 2048)
(reference preprocess/preprocess_features.py:19-28, 44-64). This is the
inference path (BatchNorm with its running statistics) in NCHW, with
torchvision's module and key names (``conv1``, ``bn1``,
``layer1.0.conv1.weight``, ``layer1.0.downsample.0/1``), so a torchvision
``resnet101().state_dict()`` loads with ``strict=True`` once its ``fc.*``
keys are dropped (``port_resnet101_state_dict``).

``compute_dtype="bfloat16"`` runs every conv and BatchNorm in bf16 with the
parameters kept in fp32 and cast per call, as the JAX package's ``_typed``
does (BatchNorm's affine in fp32, its output bf16); the pooled feature is
fp32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
    return _DTYPES[name]


class TypedConv(nn.Module):
    """A bias-free conv (2d or 3d by the weight's rank) whose fp32 weight is
    cast to the input's dtype per call: ``nn.Conv*d``'s parameter, key
    name and arithmetic."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0, groups=1, dims=2):
        super().__init__()
        k = (kernel,) * dims if isinstance(kernel, int) else tuple(kernel)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, *k))
        self.stride = (stride,) * dims if isinstance(stride, int) else tuple(stride)
        self.padding = (padding,) * dims if isinstance(padding, int) else tuple(padding)
        self.groups = groups
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x):
        conv = F.conv2d if self.weight.dim() == 4 else F.conv3d
        return conv(x, self.weight.to(x.dtype), None, self.stride, self.padding, 1, self.groups)


class TypedBatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm of any rank on an input of any float dtype, its
    affine in fp32 (``F.batch_norm`` with fp32 statistics), its output in
    the input's dtype. Keys: ``nn.BatchNorm2d``'s."""

    def _check_input_dim(self, x):
        pass

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class Bottleneck(nn.Module):
    """torchvision V1 bottleneck: 1x1 -> 3x3 (stride here) -> 1x1, expansion 4."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = TypedConv(inplanes, planes, 1)
        self.bn1 = TypedBatchNorm(planes)
        self.conv2 = TypedConv(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = TypedBatchNorm(planes)
        self.conv3 = TypedConv(planes, planes * 4, 1)
        self.bn3 = TypedBatchNorm(planes * 4)
        self.downsample = (nn.Sequential(TypedConv(inplanes, planes * 4, 1, stride=stride),
                                         TypedBatchNorm(planes * 4)) if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


class ResNet101(nn.Module):
    """Feature extractor: (B, 3, H, W) float -> (B, 2048) fp32."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), compute_dtype: str = "float32"):
        super().__init__()
        compute_dtype_of(compute_dtype)
        self.compute_dtype = compute_dtype
        self.conv1 = TypedConv(3, 64, 7, stride=2, padding=3)
        self.bn1 = TypedBatchNorm(64)
        inplanes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for block in range(n):
                stride = 2 if (stage > 0 and block == 0) else 1
                # the first block always projects (even stage 1: 64 -> 256)
                blocks.append(Bottleneck(inplanes, planes, stride, downsample=block == 0))
                inplanes = planes * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)

    def forward(self, x):
        y = x.to(compute_dtype_of(self.compute_dtype))
        y = F.relu(self.bn1(self.conv1(y)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            y = getattr(self, f"layer{stage + 1}")(y)
        # global average pool -> (B, 2048); fp32 reduction and output
        return y.float().mean(dim=(2, 3))


def port_resnet101_state_dict(sd: dict) -> dict:
    """A torchvision ``resnet101`` state_dict (tensors or numpy) -> the
    port's: the same keys without the classifier's ``fc.*``, as tensors."""
    return {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            for k, v in sd.items() if not k.startswith("fc.")}


# the reference's ImageNet normalization, INCLUDING its std blue-channel
# typo 0.224 (should be 0.225; reference preprocess_features.py:53), kept
# for features equal to the reference's
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD_REF = np.array([0.229, 0.224, 0.224], np.float32)
