"""Open-ended answer classifier (reference model/AnswerDecoder.py:184-202).

q' = Linear(q); [visual, q'] -> Dropout(0.15) -> Linear(2D -> D) -> ELU ->
BatchNorm1d -> Dropout(0.15) -> Linear(D -> num_answers). The dropouts sit
at the reference's ``classifier`` indices 0 and 4 and hold no state, so the
Linear and batch-norm layers keep the reference's indices 1, 3 and 5 in the
state_dict. The three Linears are streamed under ``compute_dtype:
bfloat16``.
"""

from __future__ import annotations

import torch
from torch import nn

from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.precision import SLinear


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with an optional per-sample ``valid`` mask (eps 1e-5).

    Training mode normalizes with the ``valid``-weighted biased batch
    variance and updates the running statistics with momentum 0.1 (flax's
    0.9), the variance with the unbiased n/(n-1) estimate, so padded rows
    of a final partial batch take no part (the JAX package's
    ``MaskedBatchNorm``). Eval mode normalizes with the running statistics.
    Names follow torch's BatchNorm1d: weight, bias, running_mean,
    running_var, num_batches_tracked.
    """

    momentum = 0.1

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, valid=None):
        if not self.training:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
            return y * self.weight + self.bias
        if valid is None:
            valid = x.new_ones((x.shape[0],))
        n = valid.sum().clamp(min=1.0)
        w = (valid / n)[:, None]
        mean = (w * x).sum(dim=0)
        var = (w * (x - mean) ** 2).sum(dim=0)  # biased, used to normalize
        with torch.no_grad():
            unbiased = var * n / (n - 1.0).clamp(min=1.0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(unbiased, self.momentum)
            self.num_batches_tracked += 1
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class OutputUnitOpenEnded(nn.Module):
    """SimpleOutputUnitOpenEnded (reference model/AnswerDecoder.py:184-202)."""

    def __init__(self, module_dim: int = 768, num_answers: int = 1000):
        super().__init__()
        self.question_proj = SLinear(module_dim, module_dim)
        self.classifier = nn.Sequential(
            Dropout(0.15),
            SLinear(2 * module_dim, module_dim),
            nn.ELU(),
            MaskedBatchNorm(module_dim),
            Dropout(0.15),
            SLinear(module_dim, num_answers),
        )

    def forward(self, question_embedding, visual_embedding, valid=None, generator=None):
        """``valid`` (B,) masks padded rows out of the batch statistics."""
        drop0, fc1, elu, bn, drop4, out = self.classifier
        x = drop0(torch.cat([visual_embedding, self.question_proj(question_embedding)], dim=1), generator)
        x = bn(elu(fc1(x)), valid)
        return out(drop4(x, generator))
