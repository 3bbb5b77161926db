"""Query attention, punishment scores and context aggregation.

Counterparts of the JAX package's ``models/attention.py`` (reference
model/utils.py:60-105, model/AnswerDecoder.py:155-182):

* ``QueryAttn``: Linear on the dynamic question embedding, L2-normalize
  (sum of squares clamped before the rsqrt), Linear -> 1, softmax over the
  sequence, THEN zero the padded positions and renormalize by sum + 1e-5;
  the attended sum is over the raw word embeddings.
* ``QueryPunish``: sigmoid(visual . Linear(guided query)) per clip,
  broadcast to module_dim // 4, the width of one GAT head.
* ``ContextSelfAttn``: dropout 0.15 (training mode) -> Linear (no bias) ->
  ELU -> Linear -> 1 -> softmax over clips -> weighted sum of the
  dropped-out visual features.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.ops.dropout import Dropout


def l2_normalize(x, dim=-1, eps=1e-12):
    """F.normalize(p=2) with the sum of squares clamped before the rsqrt."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


class QueryAttn(nn.Module):
    """Question-guided query re-reading (reference model/utils.py:60-84)."""

    def __init__(self, module_dim: int = 768):
        super().__init__()
        self.feat_enhance = nn.Linear(module_dim, module_dim)
        self.fc = nn.Linear(module_dim, 1)

    def forward(self, word_embedding, dynamic_question_embedding, question_len):
        """word_embedding (B, T, word_dim); dynamic (B, T, module_dim);
        question_len (B,). Returns (guided query (B, word_dim), attn (B, T))."""
        x = l2_normalize(self.feat_enhance(dynamic_question_embedding))
        attn = torch.softmax(self.fc(x)[..., 0], dim=1)  # softmax BEFORE masking
        t = dynamic_question_embedding.shape[1]
        steps = torch.arange(t, device=attn.device)[None, :]
        attn = attn * (steps < question_len[:, None].to(attn.device)).to(attn.dtype)
        attn = attn / (attn.sum(dim=1, keepdim=True) + 1e-5)
        return torch.einsum("bt,btd->bd", attn, word_embedding), attn


class QueryPunish(nn.Module):
    """Per-clip sigmoid relevance scores (reference model/utils.py:86-105)."""

    def __init__(self, word_dim: int = 300, module_dim: int = 768):
        super().__init__()
        self.query_weight = nn.Linear(word_dim, module_dim)

    def forward(self, question_guided, visual_feature):
        """(B, word_dim), (B, N, D) -> scores (B, N, D // 4), a broadcast view
        of one scalar per clip."""
        query = self.query_weight(question_guided)
        scores = torch.sigmoid(torch.einsum("bnd,bd->bn", visual_feature, query))
        b, n, d = visual_feature.shape
        return scores[..., None].expand(b, n, d // 4)


class ContextSelfAttn(nn.Module):
    """Clip aggregation attention (reference model/AnswerDecoder.py:155-182)."""

    def __init__(self, module_dim: int = 768):
        super().__init__()
        self.drop = Dropout(0.15)
        self.v_proj = nn.Linear(module_dim, module_dim, bias=False)
        self.attn = nn.Linear(module_dim, 1)

    def forward(self, visual_feat, generator=None):
        """(B, N, D) -> (B, D)."""
        visual_feat = self.drop(visual_feat, generator)
        attn = torch.softmax(self.attn(F.elu(self.v_proj(visual_feat))), dim=1)
        return (attn * visual_feat).sum(dim=1)
