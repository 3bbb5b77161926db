"""Plain PyTorch of the raw-video half of the published pipeline: decoded
frames to the two streams of clip features that DualVGR reads.

After NJUPT-MCC/DualVGR-VideoQA's ``preprocess/preprocess_features.py``
(``--model resnet101 | resnext101 --num_clips 16``):

* ``sample_clip_indices``: the source's sampler. ``num_clips`` centres at
  ``linspace(0, T, num_clips + 2, dtype=int32)[1:num_clips + 1]``, the F
  frames ``[centre - F/2, centre + F/2)`` around each; a clip cut at the
  start gets the first frame repeated in front, one cut at the end the
  last frame behind, and the first F frames are kept.
* ``resize_bicubic``: PIL's ``Image.resize(size, Image.BICUBIC)`` on 8-bit
  images (``libImaging/Resample.c``): the bicubic filter (a = -0.5,
  support 2) scaled by the downscale factor, each output's taps
  normalised in double precision and rounded to integers with 22
  fractional bits, a horizontal then a vertical pass, each summed in
  integers from 2^21 and clipped to 0..255 before the next reads it; a
  pass whose size does not change is skipped.
* ``resnet101``: torchvision's ResNet-101 (He et al. 2016, the v1.5
  strides on the 3x3 conv) to the pooled 2048-d feature, on frames
  normalised as the source does (``x / 255`` less the ImageNet mean, over
  its std (0.229, 0.224, 0.224), 0.224 and not 0.225 for blue as the
  source has it).
* ``resnext101_3d``: the Kinetics 3D ResNeXt-101 of Hara, Kataoka and Satoh
  (CVPR 2018; kenshohara/3D-ResNets-PyTorch ``resnext.py``): cardinality
  32, layers (3, 4, 23, 3), stage planes 128-1024 with expansion 2, a
  7x7x7 stem with stride (1, 2, 2), a 3x3x3 max pool with stride 2, type-B
  shortcuts, to the pooled 2048-d feature of raw 0-255 clips.

Both backbones are functions of a flat ``{key: tensor}`` dict in the
published checkpoints' key names (torchvision's and the Kinetics
release's, without DataParallel's ``module.`` and without ``fc``), with
``F.conv2d`` / ``F.conv3d(groups=32)``, eval-mode BatchNorm written out
(eps 1e-5) and fp32 throughout; the caller turns TF32 off. DualVGR itself
is ``dualvgr.py`` beside this file. This file imports nothing of the
program or of the benchmark.

Departures from the source, none of which moves a number it computes:

* the frames arrive decoded, (T, H, W, 3) uint8 RGB (the source decodes
  with cv2 and converts BGR to RGB);
* PIL is not called: its resampler is written out in integers here;
* the source runs a video clip by clip; here all of a video's frames go
  through ResNet-101 in one call and all its clips through ResNeXt-101;
* the global pools are means over the remaining positions, which is what
  torchvision's ``AdaptiveAvgPool2d(1)`` and the source's
  ``AvgPool3d((1, 4, 4))`` at 16 x 112^2 compute.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit images
BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
SOURCE_STD = (0.229, 0.224, 0.224)  # the source's std, its blue channel as it has it
RESNET_PLANES = (64, 128, 256, 512)
RESNEXT_PLANES = (128, 256, 512, 1024)


# ---------------------------------------------------------------- the sampler

def sample_clip_indices(total_frames: int, num_clips: int, frames_per_clip: int) -> np.ndarray:
    """(num_clips, frames_per_clip) frame indices of a video of
    ``total_frames`` frames, as the source's sampler picks them."""
    half = frames_per_clip // 2
    out = []
    for centre in np.linspace(0, total_frames, num_clips + 2, dtype=np.int32)[1:num_clips + 1]:
        start, end = int(centre) - half, int(centre) + half
        if start < 0:
            start = 0
        if end > total_frames:
            end = total_frames - 1
        clip = list(range(start, end))
        if start == 0:
            clip = [start] * (frames_per_clip - (end - start)) + clip
        if end == total_frames - 1:
            clip = clip + [end] * (frames_per_clip - (end - start))
        out.append(clip[:frames_per_clip])
    return np.asarray(out, np.int64)


# ---------------------------------------------------------------- PIL's bicubic

def _bicubic(x: float) -> float:
    a = -0.5
    if x < 0.0:
        x = -x
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def bicubic_taps(in_size: int, out_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(first input index (out_size,), integer taps (out_size, K)) of each
    output pixel; a tap past the pixel's window is 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = torch.zeros(out_size, dtype=torch.int64)
    taps = torch.zeros(out_size, ksize, dtype=torch.int64)
    for xx in range(out_size):
        centre = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(centre - support + 0.5), 0)
        xmax = min(int(centre + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - centre + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        first[xx] = xmin
        for x, v in enumerate(w):
            k = v / total if total != 0.0 else v
            taps[xx, x] = int(-0.5 + k * (1 << PRECISION_BITS)) if k < 0 else int(0.5 + k * (1 << PRECISION_BITS))
    return first, taps


def _resample_last(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """One pass along the last axis of ``x`` (int64 pixels): integer sums of
    the taps from 2^21, then PIL's clip8."""
    first, taps = bicubic_taps(x.shape[-1], out_size)
    first, taps = first.to(x.device), taps.to(x.device)
    acc = torch.full((*x.shape[:-1], out_size), 1 << (PRECISION_BITS - 1), dtype=torch.int64, device=x.device)
    for j in range(taps.shape[1]):
        idx = (first + j).clamp(max=x.shape[-1] - 1)
        acc += x[..., idx] * taps[:, j]
    return torch.div(acc, 1 << PRECISION_BITS, rounding_mode="floor").clamp(0, 255)


def resize_bicubic(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``images`` (..., H, W) uint8, each plane resized to (height, width)
    as PIL resizes an 8-bit image with ``resize((width, height), BICUBIC)``."""
    x = images.to(torch.int64)
    if x.shape[-1] != width:
        x = _resample_last(x, width)
    if x.shape[-2] != height:
        x = _resample_last(x.transpose(-1, -2), height).transpose(-1, -2)
    return x.to(torch.uint8)


def clips_of(frames: torch.Tensor, num_clips: int, frames_per_clip: int, size: int) -> torch.Tensor:
    """The sampled clips of ``frames`` (T, H, W, 3) uint8, each frame resized
    to size x size: (num_clips, frames_per_clip, 3, size, size) fp32 0-255."""
    idx = torch.as_tensor(sample_clip_indices(frames.shape[0], num_clips, frames_per_clip), device=frames.device)
    picked = frames[idx.reshape(-1)].permute(0, 3, 1, 2)  # (clips * F, 3, H, W)
    return resize_bicubic(picked, size, size).float().reshape(num_clips, frames_per_clip, 3, size, size)


# ---------------------------------------------------------------- the backbones

def _bn_keys(spec: dict, name: str, channels: int) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        spec[f"{name}.{leaf}"] = (channels,)
    spec[f"{name}.num_batches_tracked"] = ()


def resnet101_spec(layers=(3, 4, 23, 3)) -> dict:
    """``{key: shape}`` of ResNet-101's parameters and buffers, torchvision's names."""
    spec = {"conv1.weight": (64, 3, 7, 7)}
    _bn_keys(spec, "bn1", 64)
    inplanes = 64
    for s, (planes, n) in enumerate(zip(RESNET_PLANES, layers)):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            spec[f"{p}.conv1.weight"] = (planes, inplanes, 1, 1)
            _bn_keys(spec, f"{p}.bn1", planes)
            spec[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
            _bn_keys(spec, f"{p}.bn2", planes)
            spec[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
            _bn_keys(spec, f"{p}.bn3", planes * 4)
            if b == 0:
                spec[f"{p}.downsample.0.weight"] = (planes * 4, inplanes, 1, 1)
                _bn_keys(spec, f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    return spec


def resnext101_spec(layers=(3, 4, 23, 3), cardinality: int = 32) -> dict:
    """``{key: shape}`` of the 3D ResNeXt-101's parameters and buffers, the
    Kinetics release's names."""
    spec = {"conv1.weight": (64, 3, 7, 7, 7)}
    _bn_keys(spec, "bn1", 64)
    inplanes = 64
    for s, (planes, n) in enumerate(zip(RESNEXT_PLANES, layers)):
        mid = cardinality * (planes // 32)
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            spec[f"{p}.conv1.weight"] = (mid, inplanes, 1, 1, 1)
            _bn_keys(spec, f"{p}.bn1", mid)
            spec[f"{p}.conv2.weight"] = (mid, mid // cardinality, 3, 3, 3)
            _bn_keys(spec, f"{p}.bn2", mid)
            spec[f"{p}.conv3.weight"] = (planes * 2, mid, 1, 1, 1)
            _bn_keys(spec, f"{p}.bn3", planes * 2)
            if b == 0 and (stride != 1 or inplanes != planes * 2):
                spec[f"{p}.downsample.0.weight"] = (planes * 2, inplanes, 1, 1, 1)
                _bn_keys(spec, f"{p}.downsample.1", planes * 2)
            inplanes = planes * 2
    return spec


def _bn(P: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = P[f"{name}.weight"] * torch.rsqrt(P[f"{name}.running_var"] + BN_EPS)
    return (x - P[f"{name}.running_mean"].view(shape)) * scale.view(shape) + P[f"{name}.bias"].view(shape)


def resnet101(P: dict, x: torch.Tensor, layers=(3, 4, 23, 3)) -> torch.Tensor:
    """Frames (B, 3, H, W) fp32 0-255 -> their (B, 2048) pooled features."""
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(SOURCE_STD, device=x.device).view(1, 3, 1, 1)
    y = (x / 255.0 - mean) / std
    y = F.relu(_bn(P, "bn1", F.conv2d(y, P["conv1.weight"], stride=2, padding=3)))
    y = F.max_pool2d(y, 3, stride=2, padding=1)
    for s, n in enumerate(layers):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            z = F.relu(_bn(P, f"{p}.bn1", F.conv2d(y, P[f"{p}.conv1.weight"])))
            z = F.relu(_bn(P, f"{p}.bn2", F.conv2d(z, P[f"{p}.conv2.weight"], stride=stride, padding=1)))
            z = _bn(P, f"{p}.bn3", F.conv2d(z, P[f"{p}.conv3.weight"]))
            if b == 0:
                y = _bn(P, f"{p}.downsample.1", F.conv2d(y, P[f"{p}.downsample.0.weight"], stride=stride))
            y = F.relu(z + y)
    return y.mean(dim=(2, 3))


def resnext101_3d(P: dict, x: torch.Tensor, layers=(3, 4, 23, 3), cardinality: int = 32) -> torch.Tensor:
    """Clips (B, 3, F, H, W) fp32 0-255, not normalised -> their (B, 2048)
    pooled features."""
    y = F.relu(_bn(P, "bn1", F.conv3d(x, P["conv1.weight"], stride=(1, 2, 2), padding=3)))
    y = F.max_pool3d(y, 3, stride=2, padding=1)
    for s, n in enumerate(layers):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            z = F.relu(_bn(P, f"{p}.bn1", F.conv3d(y, P[f"{p}.conv1.weight"])))
            z = F.conv3d(z, P[f"{p}.conv2.weight"], stride=stride, padding=1, groups=cardinality)
            z = F.relu(_bn(P, f"{p}.bn2", z))
            z = _bn(P, f"{p}.bn3", F.conv3d(z, P[f"{p}.conv3.weight"]))
            if f"{p}.downsample.0.weight" in P:
                y = _bn(P, f"{p}.downsample.1", F.conv3d(y, P[f"{p}.downsample.0.weight"], stride=stride))
            y = F.relu(z + y)
    return y.mean(dim=(2, 3, 4))


def video_features(app_weights: dict, mot_weights: dict, frames: torch.Tensor, *, num_clips: int,
                   frames_per_clip: int, appearance_size: int, motion_size: int, layers=(3, 4, 23, 3),
                   cardinality: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """One video's decoded ``frames`` (T, H, W, 3) uint8 -> (appearance
    (num_clips, frames_per_clip, 2048), motion (num_clips, 2048)), on
    ``frames``' device."""
    c, f = num_clips, frames_per_clip
    app_clips = clips_of(frames, c, f, appearance_size)
    app = resnet101(app_weights, app_clips.reshape(c * f, 3, appearance_size, appearance_size), layers)
    mot_clips = clips_of(frames, c, f, motion_size).transpose(1, 2)  # (clips, 3, F, h, w)
    return app.reshape(c, f, -1), resnext101_3d(mot_weights, mot_clips, layers, cardinality)
