"""Question, appearance and motion encoders (reference model/Preprocessing.py),
eval mode.

* ``QuestionEncoder`` == InputUnitLinguisticDynamic: Embedding -> tanh ->
  two BiLSTMs over the words: ``concatRNN.rnn`` gives the per-token outputs
  (the dynamic question embedding, B x T x module_dim) and ``encoder`` the
  final-state sentence embedding (B x module_dim).
* ``AppearanceEncoder`` == VisualAppearanceEncoder: tanh on (B, C, F, 2048),
  a BiLSTM over the F frames of each of the B*C clips, final fwd/bwd states
  concatenated -> (B, C, module_dim).
* ``MotionEncoder``: Linear 2048 -> module_dim.

With ``use_kernel`` every BiLSTM's recurrence goes through
``bilstm_recurrence`` (the CUDA kernel on CUDA tensors) in the three modes
of the eval path: appearance final-only and unmasked, ``concatRNN``
masked with outputs, the question ``encoder`` masked and final-only.
"""

from __future__ import annotations

import torch
from torch import nn

from dualvgr_tpu_torch.ops.lstm import LSTMParams, bilstm


class BiLSTM(nn.Module):
    """Bidirectional masked LSTM over (B, T, D), with nn.LSTM's parameter
    names and shapes (weight_ih_l0 (4H, D), ..., the ``_reverse`` set)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        for sfx in ("", "_reverse"):
            self.register_parameter(f"weight_ih_l0{sfx}", nn.Parameter(torch.empty(4 * hidden, input_dim)))
            self.register_parameter(f"weight_hh_l0{sfx}", nn.Parameter(torch.empty(4 * hidden, hidden)))
            self.register_parameter(f"bias_ih_l0{sfx}", nn.Parameter(torch.zeros(4 * hidden)))
            self.register_parameter(f"bias_hh_l0{sfx}", nn.Parameter(torch.zeros(4 * hidden)))

    def _params(self, sfx):
        return LSTMParams(
            getattr(self, f"weight_ih_l0{sfx}"), getattr(self, f"weight_hh_l0{sfx}"),
            getattr(self, f"bias_ih_l0{sfx}"), getattr(self, f"bias_hh_l0{sfx}"),
        )

    def forward(self, x, lengths=None, *, with_outputs: bool, use_kernel: bool):
        """Returns (outputs (B, T, 2H) or None, final (B, 2H))."""
        return bilstm(
            self._params(""), self._params("_reverse"), x, lengths,
            with_outputs=with_outputs, use_kernel=use_kernel,
        )


class _DynamicRNN(nn.Module):
    """Holder that gives the per-token BiLSTM the reference's name
    (``concatRNN.rnn``)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.rnn = BiLSTM(input_dim, hidden)


class QuestionEncoder(nn.Module):
    """InputUnitLinguisticDynamic (reference model/Preprocessing.py:89-127)."""

    def __init__(self, vocab_size: int, word_dim: int = 300, module_dim: int = 768):
        super().__init__()
        self.encoder_embed = nn.Embedding(vocab_size, word_dim)
        self.concatRNN = _DynamicRNN(word_dim, module_dim // 2)
        self.encoder = BiLSTM(word_dim, module_dim // 2)

    def forward(self, question, question_len, *, use_kernel: bool):
        """question (B, T) int; question_len (B,) int. Returns
        (question_embedding (B, module_dim), words (B, T, word_dim),
        dynamic_question_embedding (B, T, module_dim))."""
        words = torch.tanh(self.encoder_embed(question))
        dynamic, _ = self.concatRNN.rnn(words, question_len, with_outputs=True, use_kernel=use_kernel)
        _, final = self.encoder(words, question_len, with_outputs=False, use_kernel=use_kernel)
        return final, words, dynamic


class AppearanceEncoder(nn.Module):
    """VisualAppearanceEncoder (reference model/Preprocessing.py:191-234)."""

    def __init__(self, vision_dim: int = 2048, module_dim: int = 768):
        super().__init__()
        self.module_dim = module_dim
        self.encoder = BiLSTM(vision_dim, module_dim // 2)

    def forward(self, clips, *, use_kernel: bool):
        """(B, C, F, vision_dim) -> (B, C, module_dim)."""
        b, c, f, d = clips.shape
        # each clip is one full-length sequence of F frames
        x = torch.tanh(clips).reshape(b * c, f, d)
        _, final = self.encoder(x, with_outputs=False, use_kernel=use_kernel)
        return final.view(b, c, self.module_dim)


class MotionEncoder(nn.Linear):
    """Linear vision_dim -> module_dim (reference models.py:46,74); the
    reference's ``visual_motion_input_unit`` is this Linear itself."""

    def __init__(self, vision_dim: int = 2048, module_dim: int = 768):
        super().__init__(vision_dim, module_dim)
