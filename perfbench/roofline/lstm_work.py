"""The work of the BiLSTM recurrence kernels (1, 3 and 4) at one call's
shapes: both directions, fp32 state. Each needs one (H) @ (H, 4H) product
against W_hh a valid step of a row after its first, whose input, the
initial state, is a constant zero: kernels 1 and 3 skip that product
(``csrc/bilstm_cluster.cuh``: "the first step has no product") and kernel
4 the gradient it would give (``csrc/bilstm_train_bwd.cu``, step C).

``t`` steps of ``r`` rows, hidden ``h``; ``steps`` the valid row-steps of
one direction (t * r unmasked, the lengths' sum masked); ``gb`` the bytes
of a gate input (4 fp32, 2 bf16).
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


def _products(r, h, steps) -> float:
    """The recurrent products of both directions: one a valid step of a
    row after its first."""
    return 2 * 2.0 * max(steps - r, 0) * h * 4 * h


def recurrence(t, r, h, steps, masked, with_outputs, gb=4) -> tuple[float, float]:
    """Kernel 1 (eval): the gates read at the valid steps, both W_hh, the
    final state written; the lengths, and the outputs where it has them."""
    g = 4 * h
    nbytes = gb * 2 * steps * g + 4 * 2 * h * g + gb * r * 2 * h
    nbytes += 4 * r if masked else 0
    nbytes += gb * r * t * 2 * h if with_outputs else 0
    return _products(r, h, steps), nbytes


def train_forward(t, r, h, steps, masked, with_outputs, gb=4) -> tuple[float, float]:
    """Kernel 3 (``csrc/bilstm_train_fwd.cu``): kernel 1's work, and besides
    it writes for the backward the states each step starts from, hprev and
    cprev (t, r, 2h), and the gate activations (2, t, r, 4h), all fp32 at
    every step."""
    g = 4 * h
    nbytes = gb * 2 * steps * g + 4 * (2 * h * g + r * 2 * h) + 4 * 2 * t * r * 2 * h + 4 * 2 * t * r * g
    nbytes += 4 * r if masked else 0
    nbytes += 4 * r * t * 2 * h if with_outputs else 0
    return _products(r, h, steps), nbytes


def train_backward(t, r, h, steps, masked, with_outputs) -> tuple[float, float]:
    """Kernel 4 (``csrc/bilstm_train_bwd.cu``): one product a step,
    dh_{t-1} = dgates @ W_hh^T, on kernel 3's stored activations (no gate
    product). It reads, at every step, the activations (2, t, r, 4h) and
    c_{t-1} (t, r, 2h), both fp32, and where the forward had outputs their
    gradient (r, t, 2h); and once both W_hh, the final state's gradient
    (r, 2h) and the lengths. It writes the dgates of both directions, (t,
    r, 4h) each, at every step."""
    g = 4 * h
    nbytes = 4 * (2 * t * r * g + t * r * 2 * h + 2 * h * g + r * 2 * h + 2 * t * r * g)
    nbytes += 4 * r if masked else 0
    nbytes += 4 * r * t * 2 * h if with_outputs else 0
    return _products(r, h, steps), nbytes
