"""Conv FLOPs (2 x multiply-adds) of the two feature backbones on one frame
or clip: a frozen copy of the arithmetic the program states in
``dualvgr_tpu_torch/utils/flops.py``, kept here so that a change to the
program cannot move the yardstick. BatchNorm, ReLU, pooling and the
residual adds are left out; the grouped 3x3x3 conv is counted as grouped
(the work the function needs).
"""

from __future__ import annotations


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet101_flops(height: int = 224, width: int = 224, layers=(3, 4, 23, 3)) -> float:
    """ResNet-101 on one (3, height, width) frame."""
    h, w = _out(height, 7, 2, 3), _out(width, 7, 2, 3)
    total = 2.0 * 64 * 3 * 49 * h * w
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        for block in range(n):
            s = 2 if (stage > 0 and block == 0) else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            total += 2.0 * inplanes * planes * h * w  # conv1 1x1
            total += 2.0 * planes * planes * 9 * ho * wo  # conv2 3x3, stride s
            total += 2.0 * planes * planes * 4 * ho * wo  # conv3 1x1
            if block == 0:
                total += 2.0 * inplanes * planes * 4 * ho * wo  # downsample 1x1, stride s
            inplanes, h, w = planes * 4, ho, wo
    return total


def resnext101_3d_flops(frames: int = 16, height: int = 112, width: int = 112, layers=(3, 4, 23, 3),
                        cardinality: int = 32) -> float:
    """The 3D ResNeXt-101 on one (3, frames, height, width) clip."""
    t, h, w = frames, _out(height, 7, 2, 3), _out(width, 7, 2, 3)
    total = 2.0 * 64 * 3 * 343 * t * h * w
    t, h, w = _out(t, 3, 2, 1), _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((128, 256, 512, 1024), layers)):
        mid = cardinality * (planes // 32)
        for block in range(n):
            s = 2 if (stage > 0 and block == 0) else 1
            to, ho, wo = _out(t, 3, s, 1), _out(h, 3, s, 1), _out(w, 3, s, 1)
            vol, vol_out = t * h * w, to * ho * wo
            total += 2.0 * inplanes * mid * vol  # conv1 1x1x1
            total += 2.0 * mid * (mid // cardinality) * 27 * vol_out  # conv2 3x3x3, grouped
            total += 2.0 * mid * planes * 2 * vol_out  # conv3 1x1x1
            if block == 0 and (s != 1 or inplanes != planes * 2):
                total += 2.0 * inplanes * planes * 2 * vol_out  # downsample
            inplanes, t, h, w = planes * 2, to, ho, wo
    return total


def video_flops(config: dict, frames: int, clips: int) -> float:
    """Both backbones' FLOPs on ``frames`` appearance frames and ``clips``
    motion clips at a configuration's sizes."""
    bb, v = config["backbones"], config["video"]
    return (resnet101_flops(v["appearance_size"], v["appearance_size"], bb["appearance"]["layers"]) * frames
            + resnext101_3d_flops(v["frames_per_clip"], v["motion_size"], v["motion_size"], bb["motion"]["layers"],
                                  bb["motion"]["cardinality"]) * clips)
