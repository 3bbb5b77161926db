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

Under ``compute_dtype: bfloat16`` PunishGAT's W product and AttentionSFGCN's
projection are streamed (``ops/precision.py``); the fused cycle kernel
(``ops/gat_kernel.py``) stays fp32, as the JAX package's does.

``PunishGCN`` (``graph_module: GCN``, the config's default) is the JAX
package's working form of the reference's declared-but-unbuilt GCN option:
relu(adj @ ((h * score) @ W)) with output dropout 0.15. Its
``GraphConvolution`` keeps the reference's (in, out) weight used as
``x @ W`` (GraphNN.py:9-46), not an ``nn.Linear``, and is never streamed:
the JAX package's GCN multiplies with a plain fp32 ``@`` under
``compute_dtype: bfloat16`` too.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.precision import SLinear, streamed_matmul


class _GATHead(nn.Module):
    def __init__(self, in_dim: int, head_dim: int):
        super().__init__()
        self.W = nn.Linear(in_dim, head_dim)
        self.a = nn.Linear(2 * head_dim, 1)


class PunishGAT(nn.Module):
    """Multi-head query-punished GAT (reference GraphNN.py:77-178)."""

    def __init__(self, n_heads: int = 4, head_dim: int = 192, in_dim: int = 768, dropout: float = 0.15,
                 alpha: float = 0.01):
        super().__init__()
        self.n_heads, self.head_dim = n_heads, head_dim
        self.alpha = alpha  # LeakyReLU slope of the logits
        self.stream_dtype: torch.dtype | None = None
        for h in range(n_heads):
            self.add_module(f"attention_{h}", _GATHead(in_dim, head_dim))
        self.drop = Dropout(dropout)

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
        wh = (streamed_matmul(self.drop(h, generator), w, self.stream_dtype) + bias).view(b, n, nh, hd)
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
            SLinear(in_dim, hidden), nn.Tanh(), nn.Linear(hidden, 1, bias=False)
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


class GraphConvolution(nn.Module):
    """Kipf-style GCN layer: adj @ (x @ W) (reference GraphNN.py:9-46), with
    the reference's uniform(-1/sqrt(out), 1/sqrt(out)) init drawn from
    ``generator`` (``reset_parameters``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        stdv = 1.0 / math.sqrt(self.weight.shape[1])
        with torch.no_grad():
            for p in (self.weight, self.bias):
                if p is not None:
                    p.uniform_(-stdv, stdv, generator=generator)

    def forward(self, x, adj):
        out = torch.einsum("nm,...md->...nd", adj, x @ self.weight)
        return out + self.bias if self.bias is not None else out


class PunishGCN(nn.Module):
    """The punished GCN of ``graph_module: GCN`` (JAX ``models/graph.py``
    ``PunishGCN``): the per-clip punishment score gates the node features,
    then relu(adj @ (x @ W)) and output dropout 0.15. It drops neither its
    input nor an attention (it has none), unlike PunishGAT."""

    def __init__(self, dim: int = 768):
        super().__init__()
        self.gc1 = GraphConvolution(dim, dim)
        self.drop = Dropout(0.15)

    def forward(self, h, adj, scores, generator=None):
        """h (B, N, D); adj (N, N); scores (B, N, hd) or None -> (B, N, D)."""
        if scores is not None:
            # the scores are one per-clip scalar broadcast over hd columns
            h = h * scores[..., :1]
        return self.drop(F.relu(self.gc1(h, adj)), generator)


def dense_self_loop_adjacency(num_nodes: int, dtype=torch.float32, device=None):
    """The reference's clip-graph adjacency (models.py:114-119): all-ones plus
    self loops, row-normalized; strictly positive everywhere."""
    n = num_nodes
    return (torch.full((n, n), 1.0 / (n + 1), dtype=dtype, device=device)
            + torch.eye(n, dtype=dtype, device=device) / (n + 1))
