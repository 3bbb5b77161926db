"""DualVGR: the full video-QA network (reference model/models.py:36-173).

Composition: QuestionEncoder ||| AppearanceEncoder ||| MotionEncoder ->
stacked DualVGR units -> MFB appearance x motion fusion -> ContextSelfAttn
clip aggregation -> open-ended classifier.

One unit cycle: QueryAttn re-reads the question into a guided query,
QueryPunish scores each clip of both streams, then per graph layer a
"common" and a "specific" punished GAT run over the dense clip graph of
each stream, AttentionSFGCN fuses [common, specific], and the fusion is
added to the stream. As in the JAX package, GAT bank k is
cycle * graph_layers + layer and ``unit_layers`` is wired through.

Eval mode (the default, ``model.eval()``) runs without autograd. Training
mode (``model.train()``) takes a ``valid`` mask for the classifier's batch
statistics and a generator for the dropout sites, and is differentiable.

With ``use_kernels`` the model runs the port's CUDA kernels on CUDA
tensors: in eval the BiLSTM recurrence in all three BiLSTMs and, with
graph_layers == 1, one fused graph cycle per stream and unit; in training
the trainable BiLSTM forward/backward pair in all three BiLSTMs, while the
graph cycles run as the plain modules under autograd (the fused cycle has
no backward, in the JAX package either). Without ``use_kernels``, or on
CPU tensors, the same arithmetic runs as plain PyTorch. The module
state_dict uses the reference's key names.

``compute_dtype`` ("float32", the default, or "bfloat16") is the JAX
package's mixed-precision knob (``ops/precision.py``): under "bfloat16" the
encoders' input projections, the plain GAT modules' W products, the SFGCN
projections, MFB, ContextSelfAttn's ``v_proj`` and the classifier's three
Linears stream bf16 operands with fp32 sums, and the BiLSTM gates are
rounded to bf16. It changes no parameter and no state_dict key, and can be
set on a built model (``model.compute_dtype = "bfloat16"``), like
``use_kernels``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from dualvgr_tpu_torch.models.attention import ContextSelfAttn, QueryAttn, QueryPunish
from dualvgr_tpu_torch.models.decoder import OutputUnitOpenEnded
from dualvgr_tpu_torch.models.encoders import AppearanceEncoder, MotionEncoder, QuestionEncoder
from dualvgr_tpu_torch.models.fusion import MFB
from dualvgr_tpu_torch.models.graph import AttentionSFGCN, PunishGAT, dense_self_loop_adjacency
from dualvgr_tpu_torch.models.init import init_dualvgr_
from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle
from dualvgr_tpu_torch.ops.precision import stream_dtype_of
from dualvgr_tpu_torch.utils.device import resolve_device


class DualVGROutput(NamedTuple):
    """Forward outputs (reference models.py:83,173).

    logits: (B, num_answers)
    aq_embed / mq_embed: (B, N, D), the last cycle's fused embeddings
    com_app / com_motion / aq_fusion / mq_fusion: (T, B, N, D) stacks with
    T = unit_layers * graph_layers, read by the auxiliary losses.
    """

    logits: torch.Tensor
    aq_embed: torch.Tensor
    mq_embed: torch.Tensor
    com_app: torch.Tensor
    com_motion: torch.Tensor
    aq_fusion: torch.Tensor
    mq_fusion: torch.Tensor


class DualVGRUnitStack(nn.Module):
    """Stacked DualVGR reasoning units (reference models.py:86-173)."""

    def __init__(self, word_dim: int = 300, module_dim: int = 768, num_of_nodes: int = 8,
                 graph_layers: int = 1, unit_layers: int = 2):
        super().__init__()
        d = module_dim
        u, g = unit_layers, graph_layers
        self.num_of_nodes = num_of_nodes
        self.graph_layers, self.unit_layers = g, u
        self.queryAttn = nn.ModuleList(QueryAttn(d) for _ in range(u))
        self.queryPunish_appear = nn.ModuleList(QueryPunish(word_dim, d) for _ in range(u))
        self.queryPunish_motion = nn.ModuleList(QueryPunish(word_dim, d) for _ in range(u))
        mk_gat = lambda: PunishGAT(4, d // 4, in_dim=d)
        self.acGCN = nn.ModuleList(mk_gat() for _ in range(u * g))
        self.appearance_GCN = nn.ModuleList(mk_gat() for _ in range(u * g))
        self.mcGCN = nn.ModuleList(mk_gat() for _ in range(u * g))
        self.motion_GCN = nn.ModuleList(mk_gat() for _ in range(u * g))
        self.attention_appearance = nn.ModuleList(AttentionSFGCN(d, d) for _ in range(u))
        self.attention_motion = nn.ModuleList(AttentionSFGCN(d, d) for _ in range(u))
        self.visualfusion = MFB(d, d)

    @staticmethod
    def _fused_cycle(h, scores, gat_c, gat_s, sfgcn):
        """One stream's cycle through ``gat_cycle``: (out, common, spec)."""
        return gat_cycle(h, scores, *gat_c.merged(), *gat_s.merged(), *sfgcn.merged())

    def forward(self, appearance_feat, motion_feat, dynamic_question_embedding,
                word_embedding, question_len, *, use_kernels: bool, generator=None):
        adj = dense_self_loop_adjacency(
            self.num_of_nodes, appearance_feat.dtype, appearance_feat.device
        )
        # the fused kernel covers exactly one GAT cycle (common, specific,
        # fusion, residual) and has no backward; deeper graph stacks and
        # training take the plain modules
        fused = use_kernels and not self.training and self.graph_layers == 1
        aq_fusion, mq_fusion, com_app_list, com_motion_list = [], [], [], []
        aq_embed = mq_embed = None

        for i in range(self.unit_layers):
            aq, mq = appearance_feat, motion_feat
            guided, _ = self.queryAttn[i](word_embedding, dynamic_question_embedding, question_len)
            app_scores = self.queryPunish_appear[i](guided, aq)
            mot_scores = self.queryPunish_motion[i](guided, mq)

            if fused:
                appearance_feat, com_a, spec_a = self._fused_cycle(
                    aq, app_scores, self.acGCN[i], self.appearance_GCN[i],
                    self.attention_appearance[i],
                )
                motion_feat, com_m, spec_m = self._fused_cycle(
                    mq, mot_scores, self.mcGCN[i], self.motion_GCN[i], self.attention_motion[i],
                )
                # the SFGCN fusion is exactly the residual delta
                aq_embed = appearance_feat - aq
                mq_embed = motion_feat - mq
                aq_fusion.append(spec_a)
                com_app_list.append(com_a)
                mq_fusion.append(spec_m)
                com_motion_list.append(com_m)
                continue

            for j in range(self.graph_layers):
                k = i * self.graph_layers + j
                com_app = self.acGCN[k](aq, adj, app_scores, generator)
                aq = self.appearance_GCN[k](aq, adj, app_scores, generator)
                aq_fusion.append(aq)
                com_app_list.append(com_app)
            for j in range(self.graph_layers):
                k = i * self.graph_layers + j
                com_motion = self.mcGCN[k](mq, adj, mot_scores, generator)
                mq = self.motion_GCN[k](mq, adj, mot_scores, generator)
                mq_fusion.append(mq)
                com_motion_list.append(com_motion)

            aq_embed, _ = self.attention_appearance[i](torch.stack([com_app, aq], dim=1))
            mq_embed, _ = self.attention_motion[i](torch.stack([com_motion, mq], dim=1))
            appearance_feat = appearance_feat + aq_embed
            motion_feat = motion_feat + mq_embed

        visual = self.visualfusion(appearance_feat, motion_feat)
        return (
            visual, aq_embed, mq_embed, torch.stack(com_app_list), torch.stack(com_motion_list),
            torch.stack(aq_fusion), torch.stack(mq_fusion),
        )


class DualVGR(nn.Module):
    """Full network (reference model/models.py:36-83) with the GAT graph
    module (the reference's live one; ``PunishGCN`` is not ported yet).

    Parameters are drawn at construction with the reference's init from
    ``generator`` (a fresh generator seeded 0 when none is given).
    """

    def __init__(self, vision_dim: int = 2048, module_dim: int = 768, word_dim: int = 300,
                 question_vocab_size: int = 1000, num_answers: int = 1000,
                 num_of_nodes: int = 8, graph_layers: int = 1, unit_layers: int = 2,
                 use_kernels: bool = True, compute_dtype: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_kernels = use_kernels
        self.linguistic_input_unit = QuestionEncoder(question_vocab_size, word_dim, module_dim)
        self.visual_appearance_input_unit = AppearanceEncoder(vision_dim, module_dim)
        self.visual_motion_input_unit = MotionEncoder(vision_dim, module_dim)
        self.visual_input_unit = DualVGRUnitStack(
            word_dim, module_dim, num_of_nodes, graph_layers, unit_layers
        )
        self.feature_aggregation = ContextSelfAttn(module_dim)
        self.output_unit = OutputUnitOpenEnded(module_dim, num_answers)
        init_dualvgr_(self, generator if generator is not None else torch.Generator().manual_seed(0))
        self.compute_dtype = compute_dtype
        self.eval()

    @property
    def compute_dtype(self) -> str:
        return self._compute_dtype

    @compute_dtype.setter
    def compute_dtype(self, value: str) -> None:
        """Set the stream dtype of every streamed module (those holding a
        ``stream_dtype``)."""
        sd = stream_dtype_of(value)
        self._compute_dtype = "float32" if sd is None else value
        for m in self.modules():
            if hasattr(m, "stream_dtype"):
                m.stream_dtype = sd

    def forward(self, video_appearance_feat, video_motion_feat, question,
                question_len, valid=None, *, generator=None) -> DualVGROutput:
        """video_appearance_feat (B, C, F, vision_dim); video_motion_feat
        (B, C, vision_dim); question (B, T) int; question_len (B,) int.

        In training mode, ``valid`` (B,) float masks padded rows out of the
        batch statistics, and ``generator`` (a ``torch.Generator`` on the
        inputs' device) feeds the dropout sites. Eval mode ignores both and
        runs under ``torch.no_grad()``.
        """
        if not self.training:
            with torch.no_grad():
                return self._forward(video_appearance_feat, video_motion_feat, question,
                                     question_len, None, None)
        if generator is None:
            raise ValueError("the training forward draws its dropout from an explicit torch.Generator")
        return self._forward(video_appearance_feat, video_motion_feat, question, question_len,
                             valid, generator)

    def _forward(self, video_appearance_feat, video_motion_feat, question, question_len,
                 valid, generator) -> DualVGROutput:
        kern = self.use_kernels
        question_embedding, words, dynamic = self.linguistic_input_unit(
            question, question_len, use_kernel=kern, generator=generator
        )
        app = self.visual_appearance_input_unit(
            video_appearance_feat.float(), use_kernel=kern, generator=generator
        )
        motion = self.visual_motion_input_unit(video_motion_feat.float())
        visual, aq_embed, mq_embed, com_app, com_motion, aq_f, mq_f = self.visual_input_unit(
            app, motion, dynamic, words, question_len, use_kernels=kern, generator=generator
        )
        visual = self.feature_aggregation(visual, generator)
        logits = self.output_unit(question_embedding, visual, valid, generator)
        return DualVGROutput(logits, aq_embed, mq_embed, com_app, com_motion, aq_f, mq_f)


def build_model(*, device: str | torch.device = "cuda", seed: int = 0,
                use_kernels: bool = True, compute_dtype: str = "float32", **dims) -> DualVGR:
    """A DualVGR in eval mode on ``device``, drawn from ``seed`` on the CPU
    (so the weights do not depend on the device and not on
    ``compute_dtype``). ``dims`` are DualVGR's size arguments (vision_dim,
    module_dim, word_dim, question_vocab_size, num_answers, num_of_nodes,
    graph_layers, unit_layers). Raises on a machine without CUDA unless
    ``device='cpu'``."""
    dev = resolve_device(device)
    model = DualVGR(use_kernels=use_kernels, compute_dtype=compute_dtype,
                    generator=torch.Generator().manual_seed(seed), **dims)
    return model.to(dev)
