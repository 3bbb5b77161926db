"""PIL's bicubic resize of uint8 images, in torch, on any device.

The JAX package resizes every sampled frame on the host with
``PIL.Image.resize(size, Image.BICUBIC)`` (preprocess_features.py:108-112).
The card's host has no PIL, and frames should cross to the card as uint8,
so this is PIL's 8-bit resampler (``libImaging/Resample.c``) written out:

* separable: a horizontal pass over the rows the vertical pass reads, then
  a vertical pass; a pass whose size does not change is skipped, and an
  image of the target size is returned as it is;
* the bicubic filter with a = -0.5 and support 2, scaled by the downscale
  factor (``filterscale = max(in/out, 1)``), each output pixel's taps
  normalised to sum to one, in double precision as PIL computes them;
* the taps rounded to fixed point with 22 fractional bits, each pass summed
  in integers from a rounding offset of 2^21 and clipped to 0..255
  (PIL's ``clip8``) before the next pass reads it.

The taps are computed once per (in, out) size on the host. A pass is one
float64 product with a dense (out, in) tap matrix: the products of 8-bit
pixels and 23-bit taps and their sums stay below 2^53, so the float64 sums
are the integers PIL sums, on the CPU and on the card alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


@functools.lru_cache(maxsize=64)
def taps(in_size: int, out_size: int) -> tuple[np.ndarray, int, int]:
    """PIL's fixed-point taps for resampling ``in_size`` pixels to
    ``out_size``: a dense (out_size, in_size) int64 matrix, and the first
    and one-past-last input pixels any output reads."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    mat = np.zeros((out_size, in_size), np.int64)
    first, last = in_size, 0
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)  # C's (int) truncates toward zero
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)  # left to right, as PIL adds them
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            mat[xx, xmin + x] = int(-0.5 + k * (1 << _PRECISION_BITS)) if k < 0 else int(
                0.5 + k * (1 << _PRECISION_BITS))
        first, last = min(first, xmin), max(last, xmin + xmax)
    return mat, first, last


def _pass(x: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """One pass along ``x``'s last axis (float64 holding integers 0..255):
    PIL's integer sums and ``clip8``."""
    k = torch.from_numpy(mat).to(device=x.device, dtype=torch.float64)
    s = torch.matmul(x, k.t()) + float(1 << (_PRECISION_BITS - 1))
    return torch.floor(s * (1.0 / (1 << _PRECISION_BITS))).clamp_(0.0, 255.0)


def resize_bicubic(images: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``images`` (..., H, W) uint8 resized to ``size`` = (height, width)
    as PIL's ``Image.resize((width, height), Image.BICUBIC)`` resizes each
    channel; uint8 out, on ``images``' device."""
    if images.dtype != torch.uint8:
        raise TypeError(f"resize_bicubic takes uint8 images, got {images.dtype}")
    h_in, w_in = images.shape[-2:]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out):
        return images
    y = images.to(torch.float64)
    if h_out != h_in:
        kv, first, last = taps(h_in, h_out)
        kv = kv[:, first:last]
        y = y[..., first:last, :]
    if w_out != w_in:
        y = _pass(y, taps(w_in, w_out)[0])
    if h_out != h_in:
        y = _pass(y.transpose(-1, -2), kv).transpose(-1, -2)
    return y.to(torch.uint8)

