"""Query-punished multi-head graph attention over clip nodes.

Counterparts of the JAX package's ``models/graph.py`` (reference
model/GraphNN.py:77-178, model/Attention.py:11-23). In training mode
PunishGAT drops out its input, its attention and its output (0.15 each),
drawing from the generator passed to ``forward``. The modules
keep the reference's per-head layout (``attention_{h}.W``: Linear(D, hd),
``attention_{h}.a``: Linear(2*hd, 1)), so their state_dict names are the
reference's; ``merged()`` hands the heads out merged along columns, the
layout of the plain additive computation and of the fused cycle kernel.

PunishGAT in additive form: a([Wh_i || Wh_j]) = a_src . Wh_i + a_dst . Wh_j
+ b_a, so the (B, N, N, 2*hd) pairwise concat is never built. The values,
not the logits, are gated by the punishment scores.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.ops.dropout import Dropout


class _GATHead(nn.Module):
    def __init__(self, in_dim: int, head_dim: int):
        super().__init__()
        self.W = nn.Linear(in_dim, head_dim)
        self.a = nn.Linear(2 * head_dim, 1)


class PunishGAT(nn.Module):
    """Multi-head query-punished GAT (reference GraphNN.py:77-178)."""

    alpha = 0.01  # LeakyReLU slope of the logits

    def __init__(self, n_heads: int = 4, head_dim: int = 192, in_dim: int = 768):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        for h in range(n_heads):
            self.add_module(f"attention_{h}", _GATHead(in_dim, head_dim))
        self.drop = Dropout(0.15)

    def merged(self):
        """(w (D, H*hd), b (H*hd,), a (H, 2*hd), a_bias (H,)), contiguous."""
        heads = [getattr(self, f"attention_{h}") for h in range(self.n_heads)]
        w = torch.cat([hd.W.weight for hd in heads], dim=0).t().contiguous()
        b = torch.cat([hd.W.bias for hd in heads])
        a = torch.cat([hd.a.weight for hd in heads], dim=0)
        a_bias = torch.cat([hd.a.bias for hd in heads])
        return w, b, a, a_bias

    def forward(self, h, adj, scores, generator=None):
        """h (B, N, D); adj (N, N); scores (B, N, hd) or None -> (B, N, H*hd)."""
        b, n, _ = h.shape
        nh, hd = self.n_heads, self.head_dim
        w, bias, a, a_bias = self.merged()
        wh = (self.drop(h, generator) @ w + bias).view(b, n, nh, hd)
        src = torch.einsum("bnhd,hd->bhn", wh, a[:, :hd])
        dst = torch.einsum("bnhd,hd->bhn", wh, a[:, hd:])
        e = src[..., :, None] + dst[..., None, :] + a_bias[None, :, None, None]
        e = F.leaky_relu(e, self.alpha)
        # adjacency mask (never fires for the dense self-loop adjacency)
        e = torch.where(adj[None, None] > 0, e, torch.full_like(e, -9e15))
        if scores is not None:
            wh = wh * scores[:, :, None, :]
        attn = self.drop(torch.softmax(e, dim=-1), generator)
        out = F.elu(torch.einsum("bhij,bjhd->bihd", attn, wh))
        return self.drop(out.reshape(b, n, nh * hd), generator)


class AttentionSFGCN(nn.Module):
    """2-way soft attention over the [common, specific] stack
    (reference model/Attention.py:11-23)."""

    def __init__(self, hidden: int = 768, in_dim: int = 768):
        super().__init__()
        self.project = nn.Sequential(
            nn.Linear(in_dim, hidden), nn.Tanh(), nn.Linear(hidden, 1, bias=False)
        )

    def merged(self):
        """(proj_w (D, hidden), proj_b (hidden,), score_w (hidden, 1)), contiguous."""
        return (
            self.project[0].weight.t().contiguous(),
            self.project[0].bias,
            self.project[2].weight.t().contiguous(),
        )

    def forward(self, z):
        """z (B, K, N, D) -> ((B, N, D), beta (B, K, N, 1))."""
        beta = torch.softmax(self.project(z), dim=1)
        return (beta * z).sum(dim=1), beta


def dense_self_loop_adjacency(num_nodes: int, dtype=torch.float32, device=None):
    """The reference's clip-graph adjacency (models.py:114-119): all-ones plus
    self loops, row-normalized; strictly positive everywhere."""
    n = num_nodes
    return (torch.full((n, n), 1.0 / (n + 1), dtype=dtype, device=device)
            + torch.eye(n, dtype=dtype, device=device) / (n + 1))
