"""Open-ended answer classifier (reference model/AnswerDecoder.py:184-202),
eval mode.

q' = Linear(q); [visual, q'] -> Linear(2D -> D) -> ELU -> BatchNorm1d
(running statistics) -> Linear(D -> num_answers). The dropout sites of the
reference's ``classifier`` Sequential (indices 0 and 4) are identities
here, so the Linear and batch-norm layers keep the reference's indices
1, 3 and 5 in the state_dict.
"""

from __future__ import annotations

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d in eval form: normalizes with the running statistics
    (eps 1e-5). Names follow torch's BatchNorm1d: weight, bias,
    running_mean, running_var, num_batches_tracked."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.weight + self.bias


class OutputUnitOpenEnded(nn.Module):
    """SimpleOutputUnitOpenEnded (reference model/AnswerDecoder.py:184-202)."""

    def __init__(self, module_dim: int = 768, num_answers: int = 1000):
        super().__init__()
        self.question_proj = nn.Linear(module_dim, module_dim)
        self.classifier = nn.Sequential(
            nn.Identity(),
            nn.Linear(2 * module_dim, module_dim),
            nn.ELU(),
            MaskedBatchNorm(module_dim),
            nn.Identity(),
            nn.Linear(module_dim, num_answers),
        )

    def forward(self, question_embedding, visual_embedding):
        q = self.question_proj(question_embedding)
        return self.classifier(torch.cat([visual_embedding, q], dim=1))
