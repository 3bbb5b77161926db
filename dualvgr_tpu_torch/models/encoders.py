"""Question, appearance and motion encoders (reference model/Preprocessing.py).

* ``QuestionEncoder`` == InputUnitLinguisticDynamic: Embedding -> dropout
  0.15 -> tanh -> two BiLSTMs over the words: ``concatRNN.rnn`` gives the
  per-token outputs (the dynamic question embedding, B x T x module_dim)
  and ``encoder`` the final-state sentence embedding (B x module_dim),
  then dropout 0.18.
* ``AppearanceEncoder`` == VisualAppearanceEncoder: dropout 0.15 -> tanh on
  (B, C, F, 2048), a BiLSTM over the F frames of each of the B*C clips,
  final fwd/bwd states concatenated -> dropout 0.18 -> (B, C, module_dim).
* ``MotionEncoder``: Linear 2048 -> module_dim, streamed under
  ``compute_dtype: bfloat16``.

Dropout acts in training mode only (``model.train()``) and draws from the
generator passed to ``forward``. With ``use_kernel`` every BiLSTM's
recurrence goes through the port's CUDA kernels on CUDA tensors, in the
three modes of the model: appearance final-only and unmasked,
``concatRNN`` masked with outputs, the question ``encoder`` masked and
final-only. In eval that is ``bilstm_recurrence``; in training the
trainable pair (``ops/lstm_train.py``): the appearance encoder through
``appearance_bilstm_train`` (its x, tanh of dropped-out raw features, has
nothing trainable upstream), the question encoders through
``bilstm_trainable``.

Under ``compute_dtype: bfloat16`` every BiLSTM streams its input projection
and rounds its gates to bf16 (``ops/lstm.py``); in eval with ``use_kernel``
the appearance encoder's projection is one launch of kernel 6 with tanh
fused, from the raw clips (``ops/lstm.py::appearance_final_bf16``).
"""

from __future__ import annotations

import torch
from torch import nn

from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.lstm import LSTMParams, appearance_final_bf16, bilstm
from dualvgr_tpu_torch.ops.precision import SLinear


class BiLSTM(nn.Module):
    """Bidirectional masked LSTM over (B, T, D), with nn.LSTM's parameter
    names and shapes (weight_ih_l0 (4H, D), ..., the ``_reverse`` set).
    ``stream_dtype`` (None or bf16) is set from the model's compute_dtype."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.stream_dtype: torch.dtype | None = None
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

    def forward(self, x, lengths=None, *, with_outputs: bool, use_kernel: bool,
                drop_input_grad: bool = False):
        """Returns (outputs (B, T, 2H) or None, final (B, 2H)). In training,
        ``drop_input_grad`` takes the whole-layer op that gives x no gradient
        (see ``ops/lstm.py::bilstm``)."""
        return bilstm(
            self._params(""), self._params("_reverse"), x, lengths,
            with_outputs=with_outputs, use_kernel=use_kernel, train=self.training,
            drop_input_grad=drop_input_grad, stream_dtype=self.stream_dtype,
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
        self.drop_words = Dropout(0.15)
        self.concatRNN = _DynamicRNN(word_dim, module_dim // 2)
        self.encoder = BiLSTM(word_dim, module_dim // 2)
        self.drop_sentence = Dropout(0.18)

    def forward(self, question, question_len, *, use_kernel: bool, generator=None):
        """question (B, T) int; question_len (B,) int. Returns
        (question_embedding (B, module_dim), words (B, T, word_dim),
        dynamic_question_embedding (B, T, module_dim))."""
        words = torch.tanh(self.drop_words(self.encoder_embed(question), generator))
        dynamic, _ = self.concatRNN.rnn(words, question_len, with_outputs=True, use_kernel=use_kernel)
        _, final = self.encoder(words, question_len, with_outputs=False, use_kernel=use_kernel)
        return self.drop_sentence(final, generator), words, dynamic


class AppearanceEncoder(nn.Module):
    """VisualAppearanceEncoder (reference model/Preprocessing.py:191-234)."""

    def __init__(self, vision_dim: int = 2048, module_dim: int = 768):
        super().__init__()
        self.module_dim = module_dim
        self.drop_clips = Dropout(0.15)
        self.encoder = BiLSTM(vision_dim, module_dim // 2)
        self.drop_final = Dropout(0.18)

    def forward(self, clips, *, use_kernel: bool, generator=None):
        """(B, C, F, vision_dim) -> (B, C, module_dim)."""
        b, c, f, d = clips.shape
        # each clip is one full-length sequence of F frames
        x = self.drop_clips(clips, generator).reshape(b * c, f, d)
        enc = self.encoder
        if use_kernel and enc.stream_dtype is not None and not self.training:
            # kernel 6 applies the tanh itself
            final = appearance_final_bf16(enc._params(""), enc._params("_reverse"), x.contiguous())
        else:
            _, final = enc(torch.tanh(x), with_outputs=False, use_kernel=use_kernel, drop_input_grad=True)
        return self.drop_final(final, generator).view(b, c, self.module_dim)


class MotionEncoder(SLinear):
    """Linear vision_dim -> module_dim (reference models.py:46,74); the
    reference's ``visual_motion_input_unit`` is this Linear itself."""

    def __init__(self, vision_dim: int = 2048, module_dim: int = 768):
        super().__init__(vision_dim, module_dim)
