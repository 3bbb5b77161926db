"""Plain PyTorch DualVGR: the yardstick that decides whether a run is correct.

A functional copy of the published model (NJUPT-MCC/DualVGR-VideoQA,
model/models.py and the modules it builds) as the benchmarked program runs
it: the GAT graph module, ``unit_layers`` and ``graph_layers`` wired
through, GAT bank ``k = cycle * graph_layers + layer``. It reads a flat
``{state_dict key: tensor}`` dict whose keys are the reference's, so the
same weights load into the program with ``load_state_dict`` and into this
file as they are. It imports nothing of the program and runs plain fp32
products only (the caller turns TF32 off).

Dropout draws ``torch.rand(shape) < 1 - p`` from the generator it is
given, site by site in the order of the forward, and scales the kept
values by ``1 / (1 - p)``: the rule the program states for its dropout,
so a train step here sees the masks the program saw from the same seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MFB_MM_DIM, MFB_FACTOR = 256, 2
GAT_HEADS, GAT_SLOPE = 4, 0.01
BN_EPS = 1e-5


def param_spec(*, vision_dim, module_dim, word_dim, question_vocab_size, num_answers,
               unit_layers=1, graph_layers=1, **_) -> dict:
    """``{key: shape}`` of every parameter and buffer, in the reference's names."""
    v, d, w, h4 = vision_dim, module_dim, word_dim, 2 * module_dim
    spec = {"linguistic_input_unit.encoder_embed.weight": (question_vocab_size, w)}

    def lstm(name, in_dim):
        for sfx in ("", "_reverse"):
            spec[f"{name}.weight_ih_l0{sfx}"] = (h4, in_dim)
            spec[f"{name}.weight_hh_l0{sfx}"] = (h4, d // 2)
            spec[f"{name}.bias_ih_l0{sfx}"] = (h4,)
            spec[f"{name}.bias_hh_l0{sfx}"] = (h4,)

    def linear(name, i, o, bias=True):
        spec[f"{name}.weight"] = (o, i)
        if bias:
            spec[f"{name}.bias"] = (o,)

    lstm("linguistic_input_unit.concatRNN.rnn", w)
    lstm("linguistic_input_unit.encoder", w)
    lstm("visual_appearance_input_unit.encoder", v)
    linear("visual_motion_input_unit", v, d)
    u = "visual_input_unit"
    for i in range(unit_layers):
        linear(f"{u}.queryAttn.{i}.feat_enhance", d, d)
        linear(f"{u}.queryAttn.{i}.fc", d, 1)
        linear(f"{u}.queryPunish_appear.{i}.query_weight", w, d)
        linear(f"{u}.queryPunish_motion.{i}.query_weight", w, d)
    hd = d // GAT_HEADS
    for bank in ("acGCN", "appearance_GCN", "mcGCN", "motion_GCN"):
        for k in range(unit_layers * graph_layers):
            for head in range(GAT_HEADS):
                linear(f"{u}.{bank}.{k}.attention_{head}.W", d, hd)
                linear(f"{u}.{bank}.{k}.attention_{head}.a", 2 * hd, 1)
    for stream in ("attention_appearance", "attention_motion"):
        for i in range(unit_layers):
            linear(f"{u}.{stream}.{i}.project.0", d, d)
            linear(f"{u}.{stream}.{i}.project.2", d, 1, bias=False)
    linear(f"{u}.visualfusion.linear0", d, MFB_MM_DIM * MFB_FACTOR)
    linear(f"{u}.visualfusion.linear1", d, MFB_MM_DIM * MFB_FACTOR)
    linear(f"{u}.visualfusion.linear_out", MFB_MM_DIM, d)
    linear("feature_aggregation.v_proj", d, d, bias=False)
    linear("feature_aggregation.attn", d, 1)
    linear("output_unit.question_proj", d, d)
    linear("output_unit.classifier.1", 2 * d, d)
    bn = "output_unit.classifier.3"
    for name in ("weight", "bias", "running_mean", "running_var"):
        spec[f"{bn}.{name}"] = (d,)
    spec[f"{bn}.num_batches_tracked"] = ()
    linear("output_unit.classifier.5", d, num_answers)
    return spec


BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_buffer(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in BUFFERS


class Dropout:
    """The dropout sites' draws from ``generator``; the identity without one (eval)."""

    def __init__(self, generator: torch.Generator | None):
        self.generator = generator

    def __call__(self, x, p: float):
        if self.generator is None or p == 0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device, dtype=x.dtype) < 1.0 - p
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _linear(P, name, x):
    return F.linear(x, P[f"{name}.weight"], P.get(f"{name}.bias"))


def _cell(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm(P, name, x, lengths=None, *, with_outputs=False):
    """Bidirectional LSTM over x (B, T, D), right-padded to ``lengths``: the
    forward direction keeps its state over the padding, the backward one
    starts at each row's last valid step, outputs are zero at padding.
    Returns (outputs (B, T, 2H) or None, final (B, 2H))."""
    b, t_total, _ = x.shape
    mask = None if lengths is None else torch.arange(t_total, device=x.device)[None, :] < lengths[:, None]
    finals, seqs = [], []
    for sfx, steps in (("", range(t_total)), ("_reverse", range(t_total - 1, -1, -1))):
        w_hh = P[f"{name}.weight_hh_l0{sfx}"]
        gates_x = F.linear(x, P[f"{name}.weight_ih_l0{sfx}"],
                           P[f"{name}.bias_ih_l0{sfx}"] + P[f"{name}.bias_hh_l0{sfx}"])
        h = c = x.new_zeros((b, w_hh.shape[1]))
        seq = [None] * t_total
        for t in steps:
            h_new, c_new = _cell(gates_x[:, t] + h @ w_hh.t(), c)
            if mask is None:
                h, c = h_new, c_new
                seq[t] = h
            else:
                m = mask[:, t, None]
                h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
                seq[t] = h * m
        finals.append(h)
        seqs.append(torch.stack(seq, dim=1))
    outs = torch.cat(seqs, dim=-1) if with_outputs else None
    return outs, torch.cat(finals, dim=-1)


def _l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps * eps))


def _gat(P, name, h, scores, drop):
    """Query-punished multi-head GAT over the dense clip graph (every pair
    of clips joined, so the adjacency masks nothing): per head,
    e_ij = leaky_relu(a . [W h_i || W h_j] + a_b), softmax over j, the
    values W h_j gated by clip j's score, ELU; heads concatenated."""
    x = drop(h, 0.15)
    whs, logits = [], []
    for head in range(GAT_HEADS):
        wh = _linear(P, f"{name}.attention_{head}.W", x)  # (B, N, hd)
        a = P[f"{name}.attention_{head}.a.weight"][0]
        hd = wh.shape[-1]
        e = (wh @ a[:hd])[:, :, None] + (wh @ a[hd:])[:, None, :] + P[f"{name}.attention_{head}.a.bias"]
        logits.append(F.leaky_relu(e, GAT_SLOPE))
        whs.append(wh * scores[:, :, None])
    attn = drop(torch.softmax(torch.stack(logits, dim=1), dim=-1), 0.15)  # (B, heads, N, N)
    out = torch.cat([F.elu(attn[:, k] @ whs[k]) for k in range(GAT_HEADS)], dim=-1)
    return drop(out, 0.15)


def _sfgcn(P, name, common, specific):
    z = torch.stack([common, specific], dim=1)  # (B, 2, N, D)
    beta = torch.softmax(_linear(P, f"{name}.project.2", torch.tanh(_linear(P, f"{name}.project.0", z))), dim=1)
    return (beta * z).sum(dim=1)


def forward(P, app, mot, q, qlen, *, unit_layers=1, graph_layers=1, valid=None, generator=None):
    """DualVGR on (app (B, C, F, V), mot (B, C, V), q (B, T), qlen (B,)).

    With a ``generator`` it is the training forward: dropout on, the
    classifier's batch norm on the ``valid`` rows' statistics. Without one,
    the eval forward: no dropout, the running statistics.
    Returns (logits, com_app, com_motion, aq_fusion, mq_fusion), the stacks
    (unit_layers * graph_layers, B, N, D) that the auxiliary losses read.
    """
    drop = Dropout(generator)
    qlen = qlen.long()
    words = torch.tanh(drop(F.embedding(q.long(), P["linguistic_input_unit.encoder_embed.weight"]), 0.15))
    dynamic, _ = bilstm(P, "linguistic_input_unit.concatRNN.rnn", words, qlen, with_outputs=True)
    _, sentence = bilstm(P, "linguistic_input_unit.encoder", words, qlen)
    sentence = drop(sentence, 0.18)

    b, c, f, v = app.shape
    clips = drop(app.float(), 0.15).reshape(b * c, f, v)
    _, final = bilstm(P, "visual_appearance_input_unit.encoder", torch.tanh(clips))
    app_feat = drop(final, 0.18).view(b, c, -1)
    mot_feat = _linear(P, "visual_motion_input_unit", mot.float())

    u = "visual_input_unit"
    t_total = q.shape[1]
    steps = torch.arange(t_total, device=q.device)[None, :] < qlen[:, None]
    stacks = {"com_app": [], "com_motion": [], "aq": [], "mq": []}
    for i in range(unit_layers):
        x = _l2_normalize(_linear(P, f"{u}.queryAttn.{i}.feat_enhance", dynamic))
        attn = torch.softmax(_linear(P, f"{u}.queryAttn.{i}.fc", x)[..., 0], dim=1) * steps
        attn = attn / (attn.sum(dim=1, keepdim=True) + 1e-5)
        guided = torch.einsum("bt,btw->bw", attn, words)
        scores = {}
        for stream, feat in (("appear", app_feat), ("motion", mot_feat)):
            query = _linear(P, f"{u}.queryPunish_{stream}.{i}.query_weight", guided)
            scores[stream] = torch.sigmoid(torch.einsum("bnd,bd->bn", feat, query))
        aq, mq = app_feat, mot_feat
        for j in range(graph_layers):
            k = i * graph_layers + j
            com_app = _gat(P, f"{u}.acGCN.{k}", aq, scores["appear"], drop)
            aq = _gat(P, f"{u}.appearance_GCN.{k}", aq, scores["appear"], drop)
            stacks["com_app"].append(com_app)
            stacks["aq"].append(aq)
        for j in range(graph_layers):
            k = i * graph_layers + j
            com_motion = _gat(P, f"{u}.mcGCN.{k}", mq, scores["motion"], drop)
            mq = _gat(P, f"{u}.motion_GCN.{k}", mq, scores["motion"], drop)
            stacks["com_motion"].append(com_motion)
            stacks["mq"].append(mq)
        app_feat = app_feat + _sfgcn(P, f"{u}.attention_appearance.{i}", com_app, aq)
        mot_feat = mot_feat + _sfgcn(P, f"{u}.attention_motion.{i}", com_motion, mq)

    fusion = F.elu(_linear(P, f"{u}.visualfusion.linear0", app_feat)) * \
        F.elu(_linear(P, f"{u}.visualfusion.linear1", mot_feat))
    fusion = fusion.view(*fusion.shape[:-1], MFB_MM_DIM, MFB_FACTOR).sum(-1)
    visual = F.elu(_linear(P, f"{u}.visualfusion.linear_out", fusion))

    visual = drop(visual, 0.15)
    weights = torch.softmax(_linear(P, "feature_aggregation.attn",
                                    F.elu(_linear(P, "feature_aggregation.v_proj", visual))), dim=1)
    visual = (weights * visual).sum(dim=1)

    x = torch.cat([visual, _linear(P, "output_unit.question_proj", sentence)], dim=1)
    x = F.elu(_linear(P, "output_unit.classifier.1", drop(x, 0.15)))
    bn = "output_unit.classifier.3"
    if generator is None:
        mean, var = P[f"{bn}.running_mean"], P[f"{bn}.running_var"]
    else:
        valid = x.new_ones(b) if valid is None else valid.float()
        w = (valid / valid.sum().clamp(min=1.0))[:, None]
        mean = (w * x).sum(dim=0)
        var = (w * (x - mean) ** 2).sum(dim=0)
    x = (x - mean) * torch.rsqrt(var + BN_EPS) * P[f"{bn}.weight"] + P[f"{bn}.bias"]
    logits = _linear(P, "output_unit.classifier.5", drop(x, 0.15))
    return (logits, *(torch.stack(stacks[s]) for s in ("com_app", "com_motion", "aq", "mq")))


def _masked_mean(per_row, valid):
    return (per_row * valid).sum() / valid.sum().clamp(min=1.0)


def _center_normalize(emb):
    emb = emb - emb.mean(dim=1, keepdim=True)
    return emb * torch.rsqrt(torch.clamp((emb * emb).sum(dim=2, keepdim=True), min=1e-24))


def total_loss(logits, labels, com_app, com_motion, aq, mq, *, alpha, beta, valid):
    """CE + alpha * common + beta * HSIC, each auxiliary term the mean over
    the stacks' entries (the published train.py:146-154 and utils.py:10-31):
    common = MSE of the centred, row-normalised node covariances; HSIC =
    sum over the batch of tr(R K1 R K2), R = I - 11^T / N."""
    ce = _masked_mean(F.cross_entropy(logits, labels.long(), reduction="none"), valid)
    n = aq.shape[2]
    r = torch.eye(n, dtype=aq.dtype, device=aq.device) - 1.0 / n
    dep = com = logits.new_zeros(())
    for t in range(aq.shape[0]):
        for e1, e2 in ((aq[t], com_app[t]), (mq[t], com_motion[t])):
            e1, e2 = e1 * valid[:, None, None], e2 * valid[:, None, None]
            rk1 = r @ (e1 @ e1.transpose(1, 2))
            rk2 = r @ (e2 @ e2.transpose(1, 2))
            dep = dep + (rk1 * rk2.transpose(1, 2)).sum()
        c1, c2 = _center_normalize(com_app[t]), _center_normalize(com_motion[t])
        cov1, cov2 = c1 @ c1.transpose(1, 2), c2 @ c2.transpose(1, 2)
        com = com + _masked_mean(((cov1 - cov2) ** 2).mean(dim=(1, 2)), valid)
    steps = aq.shape[0]
    return ce + alpha * com / steps + beta * dep / steps


class Adam:
    """Adam (beta 0.9, 0.999, eps 1e-8) after a global-norm clip that scales
    the gradients by max_norm / norm only when norm >= max_norm."""

    def __init__(self, params: dict, lr: float, max_norm: float = 12.0, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.max_norm, self.betas, self.eps = lr, max_norm, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0
        self.norms = []  # each step's global gradient norm before the clip

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Updates ``params`` in place; returns the clipped gradients."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        self.norms.append(float(norm))
        scale = torch.where(norm >= self.max_norm, self.max_norm / norm, torch.ones_like(norm))
        clipped = {k: g * scale for k, g in grads.items()}
        self.count += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, p in params.items():
            g = clipped[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.sub_(self.lr * (self.m[k] / c1) / denom)
        return clipped


def train_step(params: dict, buffers: dict, adam: Adam, batch, *, generator, alpha, beta, unit_layers=1,
               graph_layers=1):
    """One step on ``batch`` = (app, mot, q, qlen, answers, valid): the
    training forward, the loss, its gradients, the clip and Adam. Returns
    (loss, clipped gradients)."""
    app, mot, q, qlen, answers, valid = batch
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    logits, com_app, com_motion, aq, mq = forward(
        {**leaves, **buffers}, app, mot, q, qlen, unit_layers=unit_layers, graph_layers=graph_layers,
        valid=valid, generator=generator)
    loss = total_loss(logits, answers, com_app, com_motion, aq, mq, alpha=alpha, beta=beta, valid=valid.float())
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(params[k])) for k, g in zip(leaves, grads)}
    clipped = adam.step(params, grads)
    return float(loss.detach()), clipped


def xavier_bound(shape) -> float:
    fan_out, fan_in = shape
    return math.sqrt(6.0 / (fan_in + fan_out))
