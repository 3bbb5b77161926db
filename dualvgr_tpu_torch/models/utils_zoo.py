"""Model-utils zoo: the reference's unused helpers (model/utils.py:35-127).

The port's counterparts of the JAX package's ``models/utils_zoo.py``:

* ``mean_x``, ``pca``: numpy, the port's own copies (eigh on the
  covariance, the top-k principal axes);
* ``l2norm``: divide by the L2 norm along an axis, the sum of squares
  clamped before the rsqrt;
* ``VisualEnhanceByQuery``: text-to-visual TanhAttention, each stream
  gated by a sigmoid Linear of the other, MFB-fused.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dualvgr_tpu_torch.models.attention_zoo import TanhAttention
from dualvgr_tpu_torch.models.fusion import MFB
from dualvgr_tpu_torch.models.init import dense


def mean_x(data):
    """Column means (reference model/utils.py:35-36 'meanX')."""
    return np.mean(np.asarray(data), axis=0)


def pca(x, k: int):
    """Project (m, n) data onto its top-k principal components (reference
    model/utils.py:38-54). Returns (m, k)."""
    x = np.asarray(x, dtype=np.float64)
    if k > x.shape[1]:
        raise ValueError(f"k={k} must not exceed the feature count {x.shape[1]}")
    vals, vecs = np.linalg.eigh(np.cov((x - mean_x(x)).T))  # ascending
    return x @ vecs[:, np.argsort(-vals)[:k]]


def l2norm(x, dim: int = 2, eps: float = 1e-12):
    """Divide by the L2 norm along ``dim`` (reference model/utils.py:56-58)."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps * eps))


class VisualEnhanceByQuery(nn.Module):
    """Text-to-visual gated MFB enhancement (reference model/utils.py:107-127)."""

    def __init__(self, module_dim: int = 768):
        super().__init__()
        self.t2v = TanhAttention(module_dim)
        self.gate1 = dense(module_dim, module_dim, bias=False, init="xavier")
        self.gate2 = dense(module_dim, module_dim, bias=False, init="xavier")
        self.tv_fusion = MFB(module_dim, module_dim)

    def forward(self, dynamic_question_embedding, visual_embedding, generator=None):
        """(B, T, D), (B, N, D) -> (B, N, D)."""
        t2v = self.t2v(visual_embedding, dynamic_question_embedding, generator=generator)
        visual_final = torch.sigmoid(self.gate1(t2v)) * visual_embedding
        text_final = torch.sigmoid(self.gate2(visual_embedding)) * t2v
        return self.tv_fusion(text_final, visual_final)
