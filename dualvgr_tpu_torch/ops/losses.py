"""Training losses: cross entropy and the two DualVGR auxiliary losses.

The port's own copy of ``dualvgr_tpu/ops/losses.py`` (reference
utils.py:10-31, train.py:146-154):

* ``common_loss(emb1, emb2)``: center each embedding over the node dim,
  L2-normalize rows (the sum of squares clamped before the rsqrt, so the
  backward stays finite for an exactly-zero row), compare the
  node-covariance matrices with MSE.
* ``hsic_dependence_loss(emb1, emb2, N)``: HSIC independence penalty with
  linear kernels K = emb emb^T and the centering matrix R = I - (1/N) 11^T,
  summed over the batch: sum_b tr(R K1 R K2).

Every loss takes an optional ``valid`` (B,) mask: padded rows of a final
partial batch take no part in the means and contribute 0 to the HSIC sum.

Under data parallelism each rank holds some rows of the global batch, and
the means must be the global batch's: the means take ``count``, the valid
rows of the global batch (summed over the ranks, no gradient), as their
denominator, so each rank's loss is its rows' share of the global loss
and the global loss is the sum of the ranks' losses (HSIC, a sum over the
rows, is already a share). Padding that falls unevenly across the ranks
then changes nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(per_sample, valid, count=None):
    if count is not None:
        w = per_sample if valid is None else per_sample * valid
        return w.sum() / count.clamp(min=1.0)
    if valid is None:
        return per_sample.mean()
    return (per_sample * valid).sum() / valid.sum().clamp(min=1.0)


def cross_entropy_loss(logits, labels, valid=None, count=None):
    """Mean softmax cross entropy over the (valid) batch rows; with
    ``count``, this rank's share of the mean over ``count`` rows."""
    return _masked_mean(F.cross_entropy(logits, labels.long(), reduction="none"), valid, count)


def _center_normalize(emb):
    emb = emb - emb.mean(dim=1, keepdim=True)
    return emb * torch.rsqrt(torch.clamp((emb * emb).sum(dim=2, keepdim=True), min=1e-24))


def common_loss(emb1, emb2, valid=None, count=None):
    """MSE between normalized node-covariance matrices; emb* (B, N, D)."""
    emb1, emb2 = _center_normalize(emb1), _center_normalize(emb2)
    cov1 = torch.einsum("bnd,bmd->bnm", emb1, emb1)
    cov2 = torch.einsum("bnd,bmd->bnm", emb2, emb2)
    return _masked_mean(((cov1 - cov2) ** 2).mean(dim=(1, 2)), valid, count)


def hsic_dependence_loss(emb1, emb2, num_nodes: int, valid=None):
    """sum_b tr(R K1_b R K2_b) with R = I - (1/N) 11^T; emb* (B, N, D)."""
    n = num_nodes
    if valid is not None:
        emb1 = emb1 * valid[:, None, None]
        emb2 = emb2 * valid[:, None, None]
    r = torch.eye(n, dtype=emb1.dtype, device=emb1.device) - 1.0 / n
    rk1 = torch.einsum("nm,bmk->bnk", r, torch.einsum("bnd,bmd->bnm", emb1, emb1))
    rk2 = torch.einsum("nm,bmk->bnk", r, torch.einsum("bnd,bmd->bnm", emb2, emb2))
    # tr(RK1 @ RK2) = sum_ij RK1[i, j] RK2[j, i]
    return torch.einsum("bij,bji->", rk1, rk2)


def dualvgr_total_loss(logits, labels, aq_fusion, com_app, mq_fusion, com_motion, *,
                       alpha: float, beta: float, num_of_nodes: int, valid=None, count=None):
    """CE + alpha * mean(common) + beta * mean(HSIC), the means over the
    T = unit_layers * graph_layers entries of the (T, B, N, D) stacks (the
    reference's ``/temp``). ``count``: the global batch's valid rows under
    data parallelism (module docstring). Returns (total, {ce, common,
    dependence})."""
    ce = cross_entropy_loss(logits, labels, valid, count)
    t = aq_fusion.shape[0]
    dep = com = logits.new_zeros(())
    for i in range(t):
        dep = dep + hsic_dependence_loss(aq_fusion[i], com_app[i], num_of_nodes, valid)
        dep = dep + hsic_dependence_loss(mq_fusion[i], com_motion[i], num_of_nodes, valid)
        com = com + common_loss(com_app[i], com_motion[i], valid, count)
    total = ce + alpha * com / t + beta * dep / t
    return total, {"ce": ce, "common": com / t, "dependence": dep / t}
