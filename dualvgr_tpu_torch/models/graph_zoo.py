"""Graph zoo: the reference's unused graph modules and adjacency helpers.

The port's counterparts of the JAX package's ``models/graph_zoo.py``
(reference model/GraphNN.py's dead code), for component parity; the live
graph modules are in ``models/graph.py``.

* ``GAT`` (GraphNN.py:181-281): PunishGAT with the punishment gate off.
* ``construct_graph`` (GraphNN.py:289-300): a cosine top-k adjacency by
  ``torch.topk`` and a one-hot sum.
* ``process_adj`` (GraphNN.py:48-74): A + I and D^-1/2, the degree
  counting the exact-1 entries plus the self loop.
* ``GINLayer``, ``GatedGATLayer``, ``GatedGCNLayer`` (GraphNN.py:303-448):
  gated multi-relation message passing; ``_RelDense`` holds one Linear per
  relation as one (R, in, out) kernel.

Dropout acts in training mode and draws from the generator passed to
``forward``. Submodules carry the flax names, Linears flax's init.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from dualvgr_tpu_torch.models.graph import PunishGAT
from dualvgr_tpu_torch.models.init import dense, flax_init_
from dualvgr_tpu_torch.ops.dropout import Dropout


class GAT(nn.Module):
    """Unpunished multi-head GAT (reference GraphNN.py:246-281 over
    :181-244): input dropout, per-head ELU and concat, output dropout."""

    def __init__(self, n_heads: int = 4, head_dim: int = 192, in_dim: int = 768, dropout: float = 0.15,
                 alpha: float = 0.01):
        super().__init__()
        self.inner = PunishGAT(n_heads, head_dim, in_dim, dropout, alpha)

    def forward(self, h, adj, generator=None):
        return self.inner(h, adj, None, generator)


def construct_graph(features, topk: int):
    """KNN adjacency from cosine similarity (reference GraphNN.py:289-300).

    features (N, D) -> (N, N) 0/1 with A[i, j] = 1 for the topk + 1 nodes
    most cosine-similar to i, i itself included."""
    x = torch.as_tensor(features)
    xn = x / torch.sqrt(torch.clamp((x * x).sum(dim=1, keepdim=True), min=1e-24))
    sim = xn @ xn.T
    n = sim.shape[0]
    idx = torch.topk(sim, min(topk + 1, n), dim=1).indices
    return F.one_hot(idx, n).sum(dim=1).to(x.dtype)


def process_adj(adj):
    """(A + I, D^-1/2) for GCN normalization (reference GraphNN.py:48-74);
    the degree counts the exact-1 entries of a row plus the self loop."""
    a = torch.as_tensor(adj, dtype=torch.float32)
    degrees = (a == 1.0).sum(dim=1).to(torch.float32) + 1.0
    return a + torch.eye(a.shape[0], dtype=a.dtype, device=a.device), torch.diag(torch.rsqrt(degrees))


class _RelDense(nn.Module):
    """One Linear per relation: x (B, N, in) -> dropout((B, R, N, out))."""

    def __init__(self, num_rel: int, in_dim: int, out_dim: int, dropout: float):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(num_rel, in_dim, out_dim))
        # flax's lecun_normal on an (R, in, out) kernel: fan_in = R * in
        flax_init_(self.kernel, "lecun", num_rel * in_dim, num_rel * out_dim)
        self.bias = nn.Parameter(torch.zeros(num_rel, out_dim))
        self.drop = Dropout(dropout)

    def forward(self, x, generator=None):
        y = torch.einsum("bnd,rde->brne", x, self.kernel) + self.bias[None, :, None, :]
        return self.drop(y, generator)


class GINLayer(nn.Module):
    """Gated multi-relation GIN (reference GraphNN.py:303-347): per hop the
    neighbour sum per relation plus (1 + eps) times the node, one MLP per
    (hop, relation), the mean over relations, a sigmoid gate against the
    running state. input_dim must equal proj_dim (the residual gate)."""

    def __init__(self, input_dim: int, proj_dim: int = 512, dropout: float = 0.1, num_hop: int = 3,
                 num_rel: int = 3):
        super().__init__()
        self.num_hop, self.num_rel = num_hop, num_rel
        self.epsilon = nn.Parameter(torch.zeros(1))
        for i in range(num_hop):
            for j in range(num_rel):
                self.add_module(f"mlp{i + 1}{j + 1}", dense(input_dim, proj_dim))
        self.fa = dense(proj_dim + input_dim, proj_dim)  # one gate, shared by the hops
        self.drop = Dropout(dropout)

    def forward(self, x, input_mask, adj, generator=None):
        """x (B, N, D); input_mask (B, N); adj (B, R, N, N)."""
        mask = input_mask[..., None]
        cur = x
        for i in range(self.num_hop):
            multi = cur[:, None].expand(cur.shape[0], self.num_rel, *cur.shape[1:])
            nb = torch.einsum("brnm,brmd->brnd", adj, multi) * mask[:, None]
            cur_update = (1.0 + self.epsilon) * multi + nb
            per_rel = [self.drop(F.relu(getattr(self, f"mlp{i + 1}{j + 1}")(cur_update[:, j])), generator)
                       for j in range(self.num_rel)]
            update = torch.stack(per_rel, dim=1).mean(dim=1) * mask
            gate = torch.sigmoid(self.drop(self.fa(torch.cat([update, cur], dim=-1)), generator)) * mask
            cur = gate * update + (1.0 - gate) * cur
        return cur


class GatedGATLayer(nn.Module):
    """Scaled-dot multi-relation gated GAT (reference GraphNN.py:350-409):
    per relation attention = softmax(masked (fa x) x^T / sqrt(d)); update =
    sum_r attn (adj (fr x)) + fs x; tanh and a sigmoid gate. The
    parameters are shared by the hops."""

    def __init__(self, input_dim: int, proj_dim: int = 512, dropout: float = 0.1, num_hop: int = 3,
                 num_rel: int = 2):
        super().__init__()
        self.input_dim, self.num_hop, self.num_rel = input_dim, num_hop, num_rel
        self.fr = _RelDense(num_rel, input_dim, proj_dim, dropout)
        for j in range(num_rel):
            self.add_module(f"fa{j + 1}", dense(input_dim, input_dim, bias=False))
        self.fs = dense(input_dim, proj_dim)
        self.fg = dense(proj_dim + input_dim, proj_dim)
        self.drop = Dropout(dropout)

    def forward(self, x, input_mask, adj, generator=None):
        """x (B, N, D); input_mask (B, N); adj (B, R, N, N)."""
        mask = input_mask[..., None]
        scale = 1.0 / math.sqrt(self.input_dim)
        cur = x
        for _ in range(self.num_hop):
            att = torch.stack([
                torch.softmax(torch.where(
                    adj[:, j] > 0,
                    torch.einsum("bnd,bmd->bnm", getattr(self, f"fa{j + 1}")(cur), cur) * scale,
                    torch.full_like(adj[:, j], -9e15),
                ), dim=-1)
                for j in range(self.num_rel)
            ], dim=1)  # (B, R, N, N)
            nb = self.fr(cur, generator) * mask[:, None]  # (B, R, N, P)
            update = torch.einsum("brnm,brmd->bnd", att, torch.einsum("brnm,brmd->brnd", adj, nb))
            update = update + self.drop(self.fs(cur), generator) * mask
            gate = torch.sigmoid(self.drop(self.fg(torch.cat([update, cur], dim=-1)), generator)) * mask
            cur = gate * torch.tanh(update) + (1.0 - gate) * cur
        return cur


class GatedGCNLayer(nn.Module):
    """Entity-GCN-style gated multi-relation GCN (reference
    GraphNN.py:411-448); the parameters are shared by the hops."""

    def __init__(self, input_dim: int, proj_dim: int = 512, dropout: float = 0.1, num_hop: int = 3,
                 num_rel: int = 2):
        super().__init__()
        self.num_hop = num_hop
        self.fr = _RelDense(num_rel, input_dim, proj_dim, dropout)
        self.fs = dense(input_dim, proj_dim)
        self.fa = dense(proj_dim + input_dim, proj_dim)
        self.drop = Dropout(dropout)

    def forward(self, x, adj, generator=None):
        """x (B, N, D); adj (B, R, N, N)."""
        cur = x
        for _ in range(self.num_hop):
            update = torch.einsum("brnm,brmd->bnd", adj, self.fr(cur, generator))
            update = update + self.drop(self.fs(cur), generator)
            gate = torch.sigmoid(self.drop(self.fa(torch.cat([update, cur], dim=-1)), generator))
            cur = gate * torch.tanh(update) + (1.0 - gate) * cur
        return cur
