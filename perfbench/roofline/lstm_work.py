"""The work of the BiLSTM recurrence kernels (1, 3 and 4) at one call's
shapes: both directions, each a (H) @ (H, 4H) product a valid step (two
in the backward), fp32 gates. Inputs are read once at the valid steps,
outputs written once. A frozen copy of the counts the program's
``chip_smoke.py`` states for the same kernels.

``t`` steps of ``r`` rows, hidden ``h``; ``steps`` the valid row-steps
(t * r unmasked, the lengths' sum masked).
"""

from __future__ import annotations


def shapes(step: dict, model: dict) -> list[tuple]:
    """(t, r, steps, masked, with_outputs) of the three BiLSTMs of one
    forward: the question's per-token BiLSTM, its final-state BiLSTM, and
    the appearance BiLSTM over every clip of every row."""
    rows, q_pad, qsum = step["rows"], step["q_pad"], step["qlen_sum"]
    clips, frames = model["num_of_nodes"], model["frames_per_clip"]
    return [(q_pad, rows, qsum, True, True), (q_pad, rows, qsum, True, False),
            (frames, rows * clips, frames * rows * clips, False, False)]


def recurrence(t, r, h, steps, masked, with_outputs, gb=4) -> tuple[float, float]:
    """Kernel 1 (eval)."""
    g = 4 * h
    flops = 2.0 * steps * 2 * h * g
    nbytes = gb * 2 * steps * g + 4 * 2 * h * g + gb * r * 2 * h
    nbytes += 4 * r if masked else 0
    nbytes += gb * r * t * 2 * h if with_outputs else 0
    return flops, nbytes


def train_forward(t, r, h, steps, masked, with_outputs, gb=4) -> tuple[float, float]:
    """Kernel 3: kernel 1 plus the pre-step states kept for the backward."""
    g = 4 * h
    flops = 2.0 * steps * 2 * h * g
    nbytes = gb * 2 * steps * g + 4 * (2 * h * g + r * 2 * h) + 4 * 2 * t * r * 2 * h
    nbytes += 4 * r if masked else 0
    nbytes += 4 * r * t * 2 * h if with_outputs else 0
    return flops, nbytes


def train_backward(t, r, h, steps, masked, with_outputs, gb=4) -> tuple[float, float]:
    """Kernel 4: the gates again and dgates @ W_hh^T a valid step."""
    g = 4 * h
    flops = 2 * 2.0 * steps * 2 * h * g
    nbytes = gb * 2 * steps * g + 4 * (2 * h * g + 2 * steps * 2 * h + r * 2 * h + 2 * t * r * g)
    nbytes += 4 * r if masked else 0
    nbytes += 4 * r * t * 2 * h if with_outputs else 0
    return flops, nbytes
