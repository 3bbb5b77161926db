"""Analytic FLOP count of the DualVGR forward and train step.

The port's own copy of the JAX package's ``utils/flops.py``, with its
counts: the matmul FLOPs (2 x MACs) of every dense contraction of the
forward; elementwise, softmax and norm work is left out. The graph layers
are counted as PunishGAT's, as the JAX package counts them (a PunishGCN
layer lacks only the 4 C D of the attention's head reads). ``chip_smoke.py``
turns the count into TFLOP/s of the flagship forward.

Symbols: V=vision_dim, D=module_dim, W=word_dim, A=num_answers,
C=num_of_nodes (clips), F=frames_per_clip, T=q_len, U=unit_layers,
G=graph_layers, h=D/2 (BiLSTM per-direction hidden), H*hd=D (GAT heads).
"""

from __future__ import annotations


def _lstm_dir_flops(steps: int, in_dim: int, hidden: int) -> float:
    """One direction: per step, gate matmuls x@W_ih (in->4h) + h@W_hh (h->4h)."""
    return 2.0 * steps * 4 * hidden * (in_dim + hidden)


def dualvgr_forward_flops(
    *,
    vision_dim: int,
    module_dim: int,
    word_dim: int,
    num_answers: int,
    num_of_nodes: int,
    frames_per_clip: int,
    q_len: int,
    unit_layers: int,
    graph_layers: int,
) -> float:
    """Matmul FLOPs per QA pair for one eval forward."""
    V, D, W, A = vision_dim, module_dim, word_dim, num_answers
    C, F, T, U, G = num_of_nodes, frames_per_clip, q_len, unit_layers, graph_layers
    h = D // 2

    total = 0.0

    # QuestionEncoder: two BiLSTMs (concat_rnn + encoder) over T tokens
    total += 2 * 2 * _lstm_dir_flops(T, W, h)
    # AppearanceEncoder: BiLSTM over F frames for each of C clips
    total += 2 * C * _lstm_dir_flops(F, V, h)
    # MotionEncoder: Linear V -> D per clip
    total += 2.0 * C * V * D

    # one reasoning cycle
    per_cycle = 0.0
    # QueryAttn: Dense D->D over T tokens, Dense D->1, guided sum over W
    per_cycle += 2.0 * T * D * D + 2.0 * T * D + 2.0 * T * W
    # QueryPunish x2 streams: Dense W->D, then (C, D) . (D,) scores
    per_cycle += 2 * (2.0 * W * D + 2.0 * C * D)
    # GATs: 4 per graph layer (common+specific, both streams);
    # W proj (C, D)@(D, D) + src/dst head reads + attn @ gated values
    per_gat = 2.0 * C * D * D + 2 * 2.0 * C * D + 2.0 * C * C * D
    per_cycle += 4 * G * per_gat
    # AttentionSFGCN x2 streams over the (2, C, D) stack
    per_cycle += 2 * (2.0 * 2 * C * D * D + 2.0 * 2 * C * D)
    total += U * per_cycle

    # MFB appearance x motion fusion per clip: two D->512, one 256->D
    total += C * (2 * 2.0 * D * 512 + 2.0 * 256 * D)
    # ContextSelfAttn: Dense D->D + Dense D->1 per clip
    total += 2.0 * C * D * D + 2.0 * C * D
    # OutputUnit: q proj D->D, fc1 2D->D, classifier D->A
    total += 2.0 * D * D + 2.0 * 2 * D * D + 2.0 * D * A

    return total


def dualvgr_train_flops(**kw) -> float:
    """Matmul FLOPs per QA pair for one train step.

    Standard 3x forward for matmul-dominated nets (forward + dZ and dW
    backward matmuls); the auxiliary losses' grams are O(C^2 D) per layer
    stack entry -- folded into the ~3x as noise (<0.3% of the total).
    """
    return 3.0 * dualvgr_forward_flops(**kw)
