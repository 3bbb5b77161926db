"""3D CNN zoo: the reference's alternative Kinetics backbones, plain PyTorch.

The port's counterpart of the JAX package's ``models/backbones/
resnet3d_zoo.py``. The reference ships four unused alternatives to the
ResNeXt-101 motion backbone (reference preprocess/models/{resnet,
wide_resnet,pre_act_resnet,densenet}.py, from the Kinetics 3D-ResNets
collection), off every path of the port:

* ``resnet3d_10/18/34`` (BasicBlock) and ``resnet3d_50/101/152/200``
  (Bottleneck, expansion 4),
* ``wide_resnet3d_50(k=2)`` (WideBottleneck, expansion 2, planes x k),
* ``pre_act_resnet3d_*`` (pre-activation ordering: BN -> ReLU -> conv),
* ``densenet3d_121/169/201/264`` (growth 32, BN-ReLU-1x1-BN-ReLU-3x3 dense
  layers, avg-pool transitions).

As the live motion backbone: a 7^3 stem conv with stride (1, 2, 2), a 3^3
max pool with stride 2, type-B projection shortcuts (type A, a strided
subsample with zero-padded channels, for the ResNets too), a global
average pool, (B, 3, T, H, W) in and the pooled feature out. Eval-mode
BatchNorm. The submodules carry the flax names with ``layer{s}_{b}`` as
``layer{s}.{b}`` and ``downsample_conv``/``_bn`` as ``downsample.0``/``.1``,
so ``utils/weights.py::backbone_from_flax`` carries flax variables
across.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv3d(cin, cout, k, stride=stride, padding=padding, bias=False)


def _shortcut_a(x, out_ch, stride):
    """Type-A shortcut: a strided 1x1x1 subsample and zero-padded channels
    (reference resnet.py:17-27)."""
    if stride != 1:
        x = x[:, :, ::stride, ::stride, ::stride]
    return F.pad(x, (0, 0, 0, 0, 0, 0, 0, out_ch - x.shape[1]))


class _Block(nn.Module):
    def __init__(self, out_ch, stride, downsample, shortcut_type, inplanes):
        super().__init__()
        self.out_ch, self.stride, self.shortcut_type = out_ch, stride, shortcut_type
        self.downsample = None
        if downsample and shortcut_type != "A":
            self.downsample = nn.Sequential(_conv(inplanes, out_ch, 1, stride), nn.BatchNorm3d(out_ch))
        self.project = downsample

    def residual(self, x):
        if not self.project:
            return x
        if self.shortcut_type == "A":
            return _shortcut_a(x, self.out_ch, self.stride)
        return self.downsample(x)


class BasicBlock3D(_Block):
    def __init__(self, inplanes, planes, stride=1, downsample=False, shortcut_type="B", expansion=1):
        super().__init__(planes * expansion, stride, downsample, shortcut_type, inplanes)
        self.conv1 = _conv(inplanes, planes, 3, stride, 1)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = nn.BatchNorm3d(planes)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + self.residual(x))


class Bottleneck3D(_Block):
    def __init__(self, inplanes, planes, stride=1, downsample=False, shortcut_type="B", expansion=4):
        super().__init__(planes * expansion, stride, downsample, shortcut_type, inplanes)
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = _conv(planes, planes * expansion, 1)
        self.bn3 = nn.BatchNorm3d(planes * expansion)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + self.residual(x))


class PreActBottleneck3D(_Block):
    """Pre-activation ordering (reference pre_act_resnet.py:62-99); its
    projection shortcut is a bare conv."""

    def __init__(self, inplanes, planes, stride=1, downsample=False, expansion=4):
        super().__init__(planes * expansion, stride, False, "B", inplanes)
        self.bn1 = nn.BatchNorm3d(inplanes)
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, 1)
        self.bn3 = nn.BatchNorm3d(planes)
        self.conv3 = _conv(planes, planes * expansion, 1)
        if downsample:
            self.downsample = nn.Sequential(_conv(inplanes, planes * expansion, 1, stride))

    def forward(self, x):
        y = self.conv1(F.relu(self.bn1(x)))
        y = self.conv2(F.relu(self.bn2(y)))
        y = self.conv3(F.relu(self.bn3(y)))
        return y + (x if self.downsample is None else self.downsample(x))


class ResNet3D(nn.Module):
    """Generic 3D ResNet feature extractor: (B, 3, T, H, W) -> (B, C)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), block: str = "bottleneck", widen: int = 1,
                 shortcut_type: str = "B"):
        super().__init__()
        expansion = {"basic": 1, "bottleneck": 4, "preact_bottleneck": 4}[block]
        if widen > 1:
            expansion = 2  # WideBottleneck (reference wide_resnet.py:30-31)
        self.conv1 = _conv(3, 64, 7, (1, 2, 2), 3)
        self.bn1 = nn.BatchNorm3d(64)
        inplanes = 64
        for stage, n in enumerate(layers):
            planes = 64 * (2 ** stage) * widen
            blocks = []
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                downsample = b == 0 and (stride != 1 or inplanes != planes * expansion)
                if block == "basic":
                    blocks.append(BasicBlock3D(inplanes, planes, stride, downsample, shortcut_type, expansion))
                elif block == "bottleneck":
                    blocks.append(Bottleneck3D(inplanes, planes, stride, downsample, shortcut_type, expansion))
                else:
                    blocks.append(PreActBottleneck3D(inplanes, planes, stride, downsample, expansion))
                inplanes = planes * expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(layers)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool3d(y, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            y = getattr(self, f"layer{stage + 1}")(y)
        return y.mean(dim=(2, 3, 4))


class DenseNet3D(nn.Module):
    """3D DenseNet feature extractor (reference preprocess/models/densenet.py)."""

    def __init__(self, block_config: Sequence[int] = (6, 12, 24, 16), growth_rate: int = 32,
                 num_init_features: int = 64, bn_size: int = 4):
        super().__init__()
        self.block_config = tuple(block_config)
        self.conv0 = _conv(3, num_init_features, 7, (1, 2, 2), 3)
        self.norm0 = nn.BatchNorm3d(num_init_features)
        features = num_init_features
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                p = f"block{i}_layer{j}_"
                self.add_module(p + "norm1", nn.BatchNorm3d(features))
                self.add_module(p + "conv1", _conv(features, bn_size * growth_rate, 1))
                self.add_module(p + "norm2", nn.BatchNorm3d(bn_size * growth_rate))
                self.add_module(p + "conv2", _conv(bn_size * growth_rate, growth_rate, 3, 1, 1))
                features += growth_rate
            if i != len(block_config) - 1:
                self.add_module(f"transition{i}_norm", nn.BatchNorm3d(features))
                self.add_module(f"transition{i}_conv", _conv(features, features // 2, 1))
                features //= 2
        self.norm_final = nn.BatchNorm3d(features)

    def forward(self, x):
        y = F.relu(self.norm0(self.conv0(x)))
        y = F.max_pool3d(y, 3, stride=2, padding=1)
        for i, n_layers in enumerate(self.block_config):
            for j in range(n_layers):
                m = lambda name: getattr(self, f"block{i}_layer{j}_{name}")  # noqa: E731
                z = m("conv1")(F.relu(m("norm1")(y)))
                z = m("conv2")(F.relu(m("norm2")(z)))
                y = torch.cat([y, z], dim=1)
            if i != len(self.block_config) - 1:
                y = getattr(self, f"transition{i}_conv")(F.relu(getattr(self, f"transition{i}_norm")(y)))
                y = F.avg_pool3d(y, 2, stride=2)
        return F.relu(self.norm_final(y)).mean(dim=(2, 3, 4))


# ---- the constructors of the reference's factories ------------------------

def resnet3d_10(**kw):
    return ResNet3D(layers=(1, 1, 1, 1), block="basic", **kw)


def resnet3d_18(**kw):
    return ResNet3D(layers=(2, 2, 2, 2), block="basic", **kw)


def resnet3d_34(**kw):
    return ResNet3D(layers=(3, 4, 6, 3), block="basic", **kw)


def resnet3d_50(**kw):
    return ResNet3D(layers=(3, 4, 6, 3), block="bottleneck", **kw)


def resnet3d_101(**kw):
    return ResNet3D(layers=(3, 4, 23, 3), block="bottleneck", **kw)


def resnet3d_152(**kw):
    return ResNet3D(layers=(3, 8, 36, 3), block="bottleneck", **kw)


def resnet3d_200(**kw):
    return ResNet3D(layers=(3, 24, 36, 3), block="bottleneck", **kw)


def wide_resnet3d_50(k: int = 2, **kw):
    return ResNet3D(layers=(3, 4, 6, 3), block="bottleneck", widen=k, **kw)


def pre_act_resnet3d_50(**kw):
    return ResNet3D(layers=(3, 4, 6, 3), block="preact_bottleneck", **kw)


def pre_act_resnet3d_101(**kw):
    return ResNet3D(layers=(3, 4, 23, 3), block="preact_bottleneck", **kw)


def densenet3d_121(**kw):
    return DenseNet3D(block_config=(6, 12, 24, 16), **kw)


def densenet3d_169(**kw):
    return DenseNet3D(block_config=(6, 12, 32, 32), **kw)


def densenet3d_201(**kw):
    return DenseNet3D(block_config=(6, 12, 48, 32), **kw)


def densenet3d_264(**kw):
    return DenseNet3D(block_config=(6, 12, 64, 48), **kw)
