"""Open-ended answer classifier (reference model/AnswerDecoder.py:184-202).

q' = Linear(q); [visual, q'] -> Dropout(0.15) -> Linear(2D -> D) -> ELU ->
BatchNorm1d -> Dropout(0.15) -> Linear(D -> num_answers). The dropouts sit
at the reference's ``classifier`` indices 0 and 4 and hold no state, so the
Linear and batch-norm layers keep the reference's indices 1, 3 and 5 in the
state_dict. The three Linears are streamed under ``compute_dtype:
bfloat16``.

The reference's unused decoder variants, for component parity with the JAX
package (``decoder.py:84-190``): ``ConcatELUAttn``, ``MFBAttn`` and
``SimpleConcatELUAttn`` (question-conditioned clip aggregation) and
``GateOutputUnitOpenEnded``. Their submodules carry the flax names, their
Linears flax's xavier init with zero biases, and they are not streamed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.models.fusion import MFB
from dualvgr_tpu_torch.models.init import dense
from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.precision import SLinear
from dualvgr_tpu_torch.parallel.comm import all_reduce_sum


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d with an optional per-sample ``valid`` mask (eps 1e-5).

    Training mode normalizes with the ``valid``-weighted biased batch
    variance and updates the running statistics with momentum 0.1 (flax's
    0.9), the variance with the unbiased n/(n-1) estimate, so padded rows
    of a final partial batch take no part (the JAX package's
    ``MaskedBatchNorm``). Eval mode normalizes with the running statistics.
    Names follow torch's BatchNorm1d: weight, bias, running_mean,
    running_var, num_batches_tracked.

    Under data parallelism (``axis``, the data axis, set by
    ``parallel.tp.place_state``) the statistics are the global batch's, as
    in the JAX package, whose batch norm runs over the whole sharded
    batch: the masked count, the masked sum and then the masked squared
    deviations are summed over the axis, the sums with autograd through the
    reduction. Every rank then normalizes with the same statistics and
    updates the same running ones. (``nn.SyncBatchNorm`` takes no mask.)
    """

    momentum = 0.1

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.axis = None
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
        if self.axis is not None and self.axis.size > 1:
            n = all_reduce_sum(valid.sum(), self.axis).clamp(min=1.0)
            w = (valid / n)[:, None]
            mean = all_reduce_sum((w * x).sum(dim=0), self.axis)
            var = all_reduce_sum((w * (x - mean) ** 2).sum(dim=0), self.axis)
        else:
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


class _ClipAttn(nn.Module):
    """Shared body of the distillation variants: dropout 0.15 on the clips,
    q_proj and v_proj (no bias), attention logits from ``_scores``, softmax
    over clips, the weighted sum of the dropped-out clips."""

    def __init__(self, module_dim: int = 768):
        super().__init__()
        self.drop = Dropout(0.15)
        self.q_proj = dense(module_dim, module_dim, bias=False, init="xavier")
        self.v_proj = dense(module_dim, module_dim, bias=False, init="xavier")

    def forward(self, question_rep, visual_feat, generator=None):
        """question_rep (B, D); visual_feat (B, N, D) -> (B, D)."""
        visual_feat = self.drop(visual_feat, generator)
        q = self.q_proj(question_rep)[:, None]
        v = self.v_proj(visual_feat)
        attn = torch.softmax(self.attn(self._scores(q, v)), dim=1)
        return (attn * visual_feat).sum(dim=1)


class ConcatELUAttn(_ClipAttn):
    """Attention over [v_proj, q_proj * v_proj] -> ELU (reference
    AnswerDecoder.py:7-43)."""

    def __init__(self, module_dim: int = 768):
        super().__init__(module_dim)
        self.cat = dense(2 * module_dim, module_dim, init="xavier")
        self.attn = dense(module_dim, 1, init="xavier")

    def _scores(self, q, v):
        return F.elu(self.cat(torch.cat([v, q * v], dim=-1)))


class MFBAttn(_ClipAttn):
    """Attention logits from MFB(v_proj, q_proj * v_proj) (reference
    AnswerDecoder.py:45-79)."""

    def __init__(self, module_dim: int = 768):
        super().__init__(module_dim)
        self.cat = MFB(module_dim, module_dim, mm_dim=module_dim, factor=2)
        self.attn = dense(module_dim, 1, init="xavier")

    def _scores(self, q, v):
        return self.cat(v, q.expand_as(v) * v)


class SimpleConcatELUAttn(_ClipAttn):
    """Attention over [v_proj, q_proj] -> ELU (reference
    AnswerDecoder.py:117-153; MFBSimpleAttn, :81-115, cannot construct in
    the reference and is left out, as in the JAX package)."""

    def __init__(self, module_dim: int = 768):
        super().__init__(module_dim)
        self.cat = dense(2 * module_dim, module_dim, init="xavier")
        self.attn = dense(module_dim, 1, init="xavier")

    def _scores(self, q, v):
        return F.elu(self.cat(torch.cat([v, q.expand_as(v)], dim=-1)))


class GateOutputUnitOpenEnded(nn.Module):
    """The classifier with a learned multiplicative gate over [visual, q']
    (reference AnswerDecoder.py:204-225)."""

    def __init__(self, module_dim: int = 768, num_answers: int = 1000):
        super().__init__()
        self.question_proj = dense(module_dim, module_dim, init="xavier")
        self.gate = dense(2 * module_dim, 2 * module_dim, init="xavier")
        self.drop = Dropout(0.15)
        self.fc1 = dense(2 * module_dim, module_dim, init="xavier")
        self.bn = MaskedBatchNorm(module_dim)
        self.classifier = dense(module_dim, num_answers, init="xavier")

    def forward(self, question_embedding, visual_embedding, valid=None, generator=None):
        out = torch.cat([visual_embedding, self.question_proj(question_embedding)], dim=1)
        out = self.drop(self.gate(out) * out, generator)
        out = self.bn(F.elu(self.fc1(out)), valid)
        return self.classifier(self.drop(out, generator))
