"""Matmul FLOPs (2 x multiply-adds) of one DualVGR forward and train step
per question: a frozen copy of the arithmetic the program states in
``dualvgr_tpu_torch/utils/flops.py``, kept here so that a change to the
program cannot move the yardstick. Elementwise, softmax and norm work is
left out; a train step counts three forwards (the forward and the two
products of the backward).

Symbols: V vision_dim, D module_dim, W word_dim, A num_answers, C clips
(num_of_nodes), F frames per clip, T question tokens, U unit_layers,
G graph_layers, h = D / 2 (one direction of a BiLSTM).
"""

from __future__ import annotations


def _lstm_dir_flops(steps: int, in_dim: int, hidden: int) -> float:
    return 2.0 * steps * 4 * hidden * (in_dim + hidden)


def forward_flops(*, vision_dim, module_dim, word_dim, num_answers, num_of_nodes, frames_per_clip, q_len,
                  unit_layers, graph_layers) -> float:
    V, D, W, A = vision_dim, module_dim, word_dim, num_answers
    C, F, T, U, G = num_of_nodes, frames_per_clip, q_len, unit_layers, graph_layers
    h = D // 2
    total = 2 * 2 * _lstm_dir_flops(T, W, h)  # the two question BiLSTMs
    total += 2 * C * _lstm_dir_flops(F, V, h)  # the appearance BiLSTM, one sequence a clip
    total += 2.0 * C * V * D  # the motion Linear
    per_cycle = 2.0 * T * D * D + 2.0 * T * D + 2.0 * T * W  # QueryAttn
    per_cycle += 2 * (2.0 * W * D + 2.0 * C * D)  # QueryPunish, both streams
    per_gat = 2.0 * C * D * D + 2 * 2.0 * C * D + 2.0 * C * C * D
    per_cycle += 4 * G * per_gat  # common and specific banks of both streams
    per_cycle += 2 * (2.0 * 2 * C * D * D + 2.0 * 2 * C * D)  # AttentionSFGCN, both streams
    total += U * per_cycle
    total += C * (2 * 2.0 * D * 512 + 2.0 * 256 * D)  # MFB
    total += 2.0 * C * D * D + 2.0 * C * D  # ContextSelfAttn
    total += 2.0 * D * D + 2.0 * 2 * D * D + 2.0 * D * A  # the classifier
    return total


def train_flops(**kw) -> float:
    return 3.0 * forward_flops(**kw)


def dims_of(config: dict) -> dict:
    """``forward_flops``' arguments from a configuration file's ``model``."""
    m = config["model"]
    return dict(vision_dim=m["vision_dim"], module_dim=m["module_dim"], word_dim=m["word_dim"],
                num_answers=m["num_answers"], num_of_nodes=m["num_of_nodes"],
                frames_per_clip=m["frames_per_clip"], q_len=m["question_len"],
                unit_layers=m["unit_layers"], graph_layers=m["graph_layers"])
