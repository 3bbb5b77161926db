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


# ---- the feature-extraction backbones: conv FLOPs (2 x MACs) from the conv
# shapes; BatchNorm, ReLU, pooling and the residual adds are left out


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet101_flops(height: int = 224, width: int = 224, layers=(3, 4, 23, 3)) -> float:
    """Conv FLOPs of ``ResNet101`` on one (3, height, width) frame."""
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
                        cardinality: int = 32, max_stages: int = 4, blockdiag: bool = False) -> float:
    """Conv FLOPs of ``ResNeXt101_3D`` on one (3, frames, height, width)
    clip; the grouped convs counted as grouped (the work the function
    needs) unless ``blockdiag`` counts them as dense convs with the
    block-diagonal weight (G times the multiply-adds)."""
    t, h, w = frames, _out(height, 7, 2, 3), _out(width, 7, 2, 3)
    total = 2.0 * 64 * 3 * 343 * t * h * w
    t, h, w = _out(t, 3, 2, 1), _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    inplanes = 64
    for stage, (planes, n) in enumerate(zip((128, 256, 512, 1024), layers)):
        if stage >= max_stages:
            break
        mid = cardinality * (planes // 32)
        for block in range(n):
            s = 2 if (stage > 0 and block == 0) else 1
            to, ho, wo = _out(t, 3, s, 1), _out(h, 3, s, 1), _out(w, 3, s, 1)
            vol, vol_out = t * h * w, to * ho * wo
            total += 2.0 * inplanes * mid * vol  # conv1 1x1x1
            total += 2.0 * mid * (mid if blockdiag else mid // cardinality) * 27 * vol_out  # conv2 3x3x3
            total += 2.0 * mid * planes * 2 * vol_out  # conv3 1x1x1
            if block == 0 and (s != 1 or inplanes != planes * 2):
                total += 2.0 * inplanes * planes * 2 * vol_out  # downsample
            inplanes, t, h, w = planes * 2, to, ho, wo
    return total
