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

In fp32 with ``use_kernel`` the appearance encoder's projection is one
launch of kernel 7 for both directions, in training
(``ops/lstm_train.py``) and in eval (``ops/lstm.py::appearance_final_f32``,
where no tensor-parallel projection is set); the question encoders keep
the plain products. Under
``compute_dtype: bfloat16`` every BiLSTM streams its input projection
and rounds its gates to bf16 (``ops/lstm.py``); in eval with ``use_kernel``
the appearance encoder's projection is one launch of kernel 6 with tanh
fused, from the raw clips (``ops/lstm.py::appearance_final_bf16``).

The reference's unused question-encoder variants, for component parity
with the JAX package (``encoders.py:220-294``): ``SimpleQuestionEncoder``
and ``MultiGranularQuestionEncoder``. As in the JAX package their BiLSTMs
take the plain path only (MultiGranular's hidden size of 512 is beyond
the recurrence kernels' 384 anyway), and their submodules carry the flax
names.
"""

from __future__ import annotations

import torch
from torch import nn

from dualvgr_tpu_torch.models.init import flax_init_
from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.lstm import LSTMParams, appearance_final_bf16, appearance_final_f32, bilstm
from dualvgr_tpu_torch.ops.precision import SLinear


class BiLSTM(nn.Module):
    """Bidirectional masked LSTM over (B, T, D), with nn.LSTM's parameter
    names and shapes (weight_ih_l0 (4H, D), ..., the ``_reverse`` set).
    ``stream_dtype`` (None or bf16) is set from the model's compute_dtype;
    ``input_proj`` (None: ``ops/lstm.py::time_major_input_proj``) by tensor
    parallelism (``parallel/tp.py``)."""

    def __init__(self, input_dim: int, hidden: int):
        super().__init__()
        self.stream_dtype: torch.dtype | None = None
        self.input_proj = None
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
            drop_input_grad=drop_input_grad, stream_dtype=self.stream_dtype, proj=self.input_proj,
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
        kernel_eval = use_kernel and not self.training
        if kernel_eval and enc.stream_dtype is not None:
            # kernel 6 applies the tanh itself
            final = appearance_final_bf16(enc._params(""), enc._params("_reverse"), x.contiguous())
        elif kernel_eval and enc.input_proj is None:
            final = appearance_final_f32(enc._params(""), enc._params("_reverse"), torch.tanh(x).contiguous())
        else:
            _, final = enc(torch.tanh(x), with_outputs=False, use_kernel=use_kernel, drop_input_grad=True)
        return self.drop_final(final, generator).view(b, c, self.module_dim)


class MotionEncoder(SLinear):
    """Linear vision_dim -> module_dim (reference models.py:46,74); the
    reference's ``visual_motion_input_unit`` is this Linear itself."""

    def __init__(self, vision_dim: int = 2048, module_dim: int = 768):
        super().__init__(vision_dim, module_dim)


def _embedding(vocab_size: int, word_dim: int) -> nn.Embedding:
    """The reference's U(-1, 1) word embedding."""
    emb = nn.Embedding(vocab_size, word_dim)
    nn.init.uniform_(emb.weight, -1.0, 1.0)
    return emb


def _xavier_lstm(lstm: BiLSTM) -> BiLSTM:
    """xavier_uniform weights on torch's (4H, D) shapes, zero biases (the
    JAX BiLSTM's init)."""
    for name, p in lstm.named_parameters():
        if p.ndim == 2:
            flax_init_(p, "xavier", p.shape[1], p.shape[0])
    return lstm


class SimpleQuestionEncoder(nn.Module):
    """InputUnitLinguistic (reference model/Preprocessing.py:47-86): one
    BiLSTM gives both the per-step outputs and the final-state embedding."""

    def __init__(self, vocab_size: int, word_dim: int = 300, module_dim: int = 768):
        super().__init__()
        self.encoder_embed = _embedding(vocab_size, word_dim)
        self.drop_words = Dropout(0.15)
        self.concat_rnn = _xavier_lstm(BiLSTM(word_dim, module_dim // 2))
        self.drop_sentence = Dropout(0.18)

    def forward(self, question, question_len, generator=None):
        """-> (question_embedding (B, D), words (B, T, word_dim), outputs (B, T, D))."""
        words = torch.tanh(self.drop_words(self.encoder_embed(question), generator))
        outputs, final = self.concat_rnn(words, question_len, with_outputs=True, use_kernel=False)
        return self.drop_sentence(final, generator), words, outputs


class MultiGranularQuestionEncoder(nn.Module):
    """MultiGranularInputUnitLinguistic (reference Preprocessing.py:129-189):
    word, phrase (1-, 2-, 3-gram dilated convolutions, max over the three)
    and sentence (a BiLSTM over the phrases) granularities, concatenated,
    then a BiLSTM over the concatenation."""

    # (kernel, padding, dilation) of the uni-, bi- and trigram convolutions:
    # each keeps the sequence length
    GRAMS = (("unigram_conv", 1, 0, 1), ("bigram_conv", 2, 1, 2), ("trigram_conv", 3, 2, 2))

    def __init__(self, vocab_size: int, word_dim: int = 300, module_dim: int = 512):
        super().__init__()
        d = module_dim
        self.encoder_embed = _embedding(vocab_size, word_dim)
        self.drop = Dropout(0.15)
        for name, k, pad, dil in self.GRAMS:
            conv = nn.Conv1d(word_dim, d, k, padding=pad, dilation=dil)
            flax_init_(conv.weight, "xavier", word_dim * k, d * k)
            nn.init.zeros_(conv.bias)
            self.add_module(name, conv)
        self.encoder = _xavier_lstm(BiLSTM(d, d // 2))
        self.concat_rnn = _xavier_lstm(BiLSTM(word_dim + 2 * d, d))

    def forward(self, question, question_len, generator=None):
        """-> (final (B, 2D), words (B, T, word_dim), dynamic (B, T, 2D))."""
        words = torch.tanh(self.drop(self.encoder_embed(question), generator))
        w = words.transpose(1, 2)  # (B, word_dim, T) for the convolutions
        grams = [getattr(self, name)(w) for name, *_ in self.GRAMS]
        phrase = torch.stack(grams, dim=2).amax(dim=2).transpose(1, 2)  # (B, T, D)
        sentence, _ = self.encoder(phrase, with_outputs=True, use_kernel=False)
        concat = torch.cat([words, phrase, sentence], dim=2)
        dynamic, final = self.concat_rnn(concat, question_len, with_outputs=True, use_kernel=False)
        return self.drop(final, generator), words, self.drop(dynamic, generator)
