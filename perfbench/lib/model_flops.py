"""Matmul FLOPs (2 x multiply-adds) of one DualVGR forward and train step
per question. ``forward_flops`` is a frozen copy of the arithmetic the
program states in ``dualvgr_tpu_torch/utils/flops.py``, kept here so that
a change to the program cannot move the yardstick. Elementwise, softmax
and norm work is left out.

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


def untaken_input_grad_flops(*, vision_dim, module_dim, frames_per_clip, num_of_nodes, **_) -> float:
    """The products of the forward whose input gradient the port's train
    step never takes, per question:

    - the appearance BiLSTM's input projection, both directions: its x is
      tanh(dropout(features)) and the features are leaves
      (``dualvgr_tpu_torch/train_lib.py:173``); the kernel path's op gives x
      no gradient (``ops/lstm_train.py:135``) and refuses an x that requires
      one (``ops/lstm_train.py:143``), and autograd on the plain path takes
      none for a tensor that needs none;
    - the motion Linear (``models/encoders.py:146``), on the same leaves;
    - the first step's recurrent product of each BiLSTM sequence and
      direction, whose input is the initial state, a constant zero: kernel 4
      skips it (``csrc/bilstm_train_bwd.cu:270``), and on the plain path the
      state starts as a tensor that needs no gradient
      (``ops/lstm_kernel.py:226``). Four sequences a question (two question
      BiLSTMs, two directions), two a clip.
    """
    V, D, F, C = vision_dim, module_dim, frames_per_clip, num_of_nodes
    h = D // 2
    appearance_proj = 2 * C * 2.0 * F * V * 4 * h
    motion = 2.0 * C * V * D
    first_steps = (4 + 2 * C) * 2.0 * h * 4 * h
    return appearance_proj + motion + first_steps


def train_flops(**kw) -> float:
    """The work of one train step per question as the port does it: the
    forward; each weight's gradient, a product as large as its forward
    product; and the input gradients the backward takes, which are those of
    every product but ``untaken_input_grad_flops``'. This departs from
    ``dualvgr_tpu_torch/utils/flops.py::dualvgr_train_flops``, which counts
    three forwards (the JAX package's count, held equal to it by the
    program's tests): that count adds work the port never does, 34% more
    than the step's at MSRVTT-QA's sizes, so a share of the card's peak
    read against it could pass 100%. The auxiliary losses' grams are left
    out, as in the forward."""
    return 3.0 * forward_flops(**kw) - untaken_input_grad_flops(**kw)


def dims_of(config: dict) -> dict:
    """``forward_flops``' arguments from a configuration file's ``model``."""
    m = config["model"]
    return dict(vision_dim=m["vision_dim"], module_dim=m["module_dim"], word_dim=m["word_dim"],
                num_answers=m["num_answers"], num_of_nodes=m["num_of_nodes"],
                frames_per_clip=m["frames_per_clip"], q_len=m["question_len"],
                unit_layers=m["unit_layers"], graph_layers=m["graph_layers"])
