"""MFB bilinear pooling (reference model/fusions/fusions.py:382-453).

The appearance x motion fusion at the end of the DualVGR unit stack:
input dims [768, 768], output 768, mm_dim 256, factor 2, ELU in and out.
The (mm_dim, factor) reshape sums adjacent column pairs. The three Linears
are streamed under ``compute_dtype: bfloat16``.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.ops.precision import SLinear


class MFB(nn.Module):
    """Multimodal Factorized Bilinear pooling."""

    def __init__(self, input_dim: int = 768, output_dim: int = 768, mm_dim: int = 256,
                 factor: int = 2):
        super().__init__()
        self.mm_dim, self.factor = mm_dim, factor
        self.linear0 = SLinear(input_dim, mm_dim * factor)
        self.linear1 = SLinear(input_dim, mm_dim * factor)
        self.linear_out = SLinear(mm_dim, output_dim)

    def forward(self, x0, x1):
        """x0, x1 (..., D) -> (..., output_dim)."""
        z = F.elu(self.linear0(x0)) * F.elu(self.linear1(x1))
        z = z.view(*z.shape[:-1], self.mm_dim, self.factor).sum(-1)
        return F.elu(self.linear_out(z))
