"""The explicit device of the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. There is no
fallback: asking for CUDA on a machine without it is an error, and the CPU
is used only when the caller names it (as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no CUDA
    device is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
