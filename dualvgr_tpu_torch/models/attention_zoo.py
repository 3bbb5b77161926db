"""Attention zoo: the reference's unused attention classes.

The port's counterparts of the JAX package's ``models/attention_zoo.py``
(reference model/Attention.py), for component parity; nothing on the
DualVGR path uses them. The classes the reference cannot run are left out,
as in the JAX package; ``GatedNLT`` takes plain Linears for the
reference's undefined ``FCNet``.

* ``MultiHeadAttention`` keeps the heads as an einsum axis;
* ``TanhAttention``'s direction masks come from ``torch.triu`` /
  ``torch.tril`` on the input's device (the reference builds them in
  Python loops on 'cuda');
* ``RNNEncoder`` runs the port's plain masked BiLSTM (``ops/lstm.py``),
  with no sort, pack and unsort; its parameters keep the flax names and
  (in, 4H) layout (``w_ih_l{layer}_{fwd,bwd}``, ...).

Dropout acts in training mode and draws from the generator passed to
``forward``. Submodules carry the flax names, Linears flax's init, and the
LayerNorms flax's epsilon (1e-6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.models.init import dense, flax_init_
from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.lstm import LSTMParams, bilstm, lstm_unroll

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's


class ScaledDotProductAttention(nn.Module):
    """softmax(q k^T / temperature) v (reference Attention.py:25-47)."""

    def __init__(self, temperature: float, attn_dropout: float = 0.1):
        super().__init__()
        self.temperature = temperature
        self.drop = Dropout(attn_dropout)

    def forward(self, q, k, v, mask=None, generator=None):
        """q (B, Lq, Dk); k (B, Lk, Dk); v (B, Lk, Dv); mask (B, Lq, Lk)
        bool, True where masked out. Returns (out, attn)."""
        attn = torch.einsum("bqd,bkd->bqk", q, k) / self.temperature
        if mask is not None:
            attn = attn.masked_fill(mask, float("-inf"))
        attn = self.drop(torch.softmax(attn, dim=2), generator)
        return torch.einsum("bqk,bkd->bqd", attn, v), attn


class MultiHeadAttention(nn.Module):
    """Multi-head attention with residual and LayerNorm (reference
    Attention.py:49-103)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, dropout: float = 0.1):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        for name, d in (("w_qs", d_k), ("w_ks", d_k), ("w_vs", d_v)):
            lin = dense(d_model, n_head * d, init="torch")
            # the reference's normal(0, sqrt(2 / (d_model + d)))
            nn.init.normal_(lin.weight, 0.0, math.sqrt(2.0 / (d_model + d)))
            self.add_module(name, lin)
        self.attn_drop = Dropout(0.1)
        self.fc = dense(n_head * d_v, d_model, init="xavier_normal")
        self.drop = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def forward(self, q, k, v, mask=None, generator=None):
        h = self.n_head
        residual = q
        qh = self.w_qs(q).unflatten(-1, (h, self.d_k))
        kh = self.w_ks(k).unflatten(-1, (h, self.d_k))
        vh = self.w_vs(v).unflatten(-1, (h, self.d_v))
        attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(self.d_k)
        if mask is not None:
            attn = attn.masked_fill(mask[:, None], float("-inf"))
        attn = self.attn_drop(torch.softmax(attn, dim=-1), generator)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vh).flatten(-2)
        out = self.drop(self.fc(out), generator)
        return self.layer_norm(out + residual), attn


class PositionwiseFeedForward(nn.Module):
    """Two position-wise layers with residual and LayerNorm (reference
    Attention.py:105-122; its 1x1 Conv1d is a Linear over the features)."""

    def __init__(self, d_in: int, d_hid: int, dropout: float = 0.1):
        super().__init__()
        self.w_1 = dense(d_in, d_hid)
        self.w_2 = dense(d_hid, d_in)
        self.drop = Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_in, eps=LAYER_NORM_EPS)

    def forward(self, x, generator=None):
        y = self.drop(self.w_2(F.relu(self.w_1(x))), generator)
        return self.layer_norm(y + x)


class EncoderLayer(nn.Module):
    """Multi-head attention then the position-wise block (reference
    Attention.py:124-143)."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int, d_v: int, dropout: float = 0.1):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dropout)

    def forward(self, q, k, v, non_pad_mask=None, slf_attn_mask=None, generator=None):
        out, attn = self.slf_attn(q, k, v, mask=slf_attn_mask, generator=generator)
        if non_pad_mask is not None:
            out = out * non_pad_mask
        out = self.pos_ffn(out, generator)
        if non_pad_mask is not None:
            out = out * non_pad_mask
        return out, attn


class AttentionC(nn.Module):
    """Question-gated channel attention (reference Attention.py:145-168,
    'Attention_C'): score = tanh(op v + proj(q)), a sigmoid gate mixing the
    heads."""

    def __init__(self, dim: int, num_hid: int, head: int = 16):
        super().__init__()
        self.num_hid = num_hid
        self.op = nn.Parameter(torch.ones(1, head, 1))
        self.fc1 = dense(dim, num_hid)
        self.w = dense(head, 1)

    def forward(self, v, q1):
        """v (B, 1, num_hid); q1 (B, dim) -> gated v (B, 1, num_hid)."""
        q_proj = self.fc1(q1).view(v.shape[0], 1, self.num_hid)
        score = torch.tanh(self.op * v + q_proj).transpose(1, 2)  # (B, num_hid, head)
        return torch.sigmoid(self.w(score)).transpose(1, 2) * v


class RNNEncoder(nn.Module):
    """Multi-layer (Bi)LSTM text encoder (reference Attention.py:170-230).

    Returns (per-step outputs (B, T, dirs * H), the final hidden states
    (B, layers * dirs * H) in [l0 fwd, l0 bwd, l1 fwd, ...] order, the
    embedded input). Zero lengths count as 1, as the reference's
    masked_fill makes them."""

    def __init__(self, word_size: int, hidden_size: int, bidirectional: bool = True, n_layers: int = 2):
        super().__init__()
        self.bidirectional, self.n_layers = bidirectional, n_layers
        h, d = hidden_size, word_size
        for layer in range(n_layers):
            for sfx in ("fwd", "bwd") if bidirectional else ("fwd",):
                for name, shape in (("w_ih", (d, 4 * h)), ("w_hh", (h, 4 * h))):
                    w = nn.Parameter(torch.empty(shape))
                    flax_init_(w, "xavier", shape[0], shape[1])  # xavier on torch's (4H, in) shape
                    self.register_parameter(f"{name}_l{layer}_{sfx}", w)
                for name in ("b_ih", "b_hh"):
                    self.register_parameter(f"{name}_l{layer}_{sfx}", nn.Parameter(torch.zeros(4 * h)))
            d = 2 * h if bidirectional else h

    def _params(self, layer, sfx) -> LSTMParams:
        g = lambda name: getattr(self, f"{name}_l{layer}_{sfx}")
        return LSTMParams(g("w_ih").t(), g("w_hh").t(), g("b_ih"), g("b_hh"))

    def forward(self, embedded, input_lengths):
        lengths = torch.clamp(input_lengths.long(), min=1)
        x, finals = embedded, []
        for layer in range(self.n_layers):
            if self.bidirectional:
                x, final = bilstm(self._params(layer, "fwd"), self._params(layer, "bwd"), x, lengths)
            else:
                x, final = lstm_unroll(self._params(layer, "fwd"), x, lengths)
            finals.append(final)
        return x, torch.cat(finals, dim=-1), embedded


class TanhAttention(nn.Module):
    """Additive cross attention with optional direction masks (reference
    Attention.py:232-264)."""

    def __init__(self, d_model: int, dropout: float = 0.0, direction: str | None = None):
        super().__init__()
        self.direction = direction
        self.ws1 = dense(d_model, d_model)
        self.ws2 = dense(d_model, d_model)
        self.wst = dense(d_model, 1)
        self.drop = Dropout(dropout)

    def forward(self, x, memory, memory_mask=None, generator=None):
        """x (B, L1, D); memory (B, L2, D); memory_mask (B, L2) 0/1."""
        item = self.ws1(x)[:, :, None, :] + self.ws2(memory)[:, None, :, :]  # (B, L1, L2, D)
        s = self.wst(torch.tanh(item))[..., 0]
        if memory_mask is not None:
            s = s.masked_fill(memory_mask[:, None, :] == 0, -1e30)
            if self.direction in ("forward", "backward"):
                ones = torch.ones(s.shape[1], s.shape[1], dtype=torch.bool, device=s.device)
                # forward: row i attends to j >= i; backward: to j <= i
                keep = torch.triu(ones) if self.direction == "forward" else torch.tril(ones)
                s = s.masked_fill(~keep[None], -1e30)
        s = self.drop(torch.softmax(s, dim=-1), generator)
        return torch.einsum("bqk,bkd->bqd", s, memory)


class WordAttention(nn.Module):
    """Context-scored word pooling, the padding masked after the softmax
    (reference Attention.py:267-297), as the live QueryAttn does."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.fc = dense(input_dim, 1)

    def forward(self, context, embedded, input_labels):
        attn = torch.softmax(self.fc(context)[..., 0], dim=1)
        attn = attn * (input_labels != 0).to(attn.dtype)
        attn = attn / (attn.sum(dim=1, keepdim=True) + 1e-5)
        return attn, torch.einsum("bt,btd->bd", attn, embedded)


class GatedNLT(nn.Module):
    """tanh(fc1 x) gated by tanh(fc2 x) (reference Attention.py:329-341,
    'Gated_NLT')."""

    def __init__(self, in_dim: int, inner_dim: int):
        super().__init__()
        self.fc1 = dense(in_dim, inner_dim)
        self.fc2 = dense(in_dim, inner_dim)

    def forward(self, x):
        return torch.tanh(self.fc2(x)) * torch.tanh(self.fc1(x))
