#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``dualvgr_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA device (an H100 is the target) and ``nvcc``. Phases, one
line each, in this order ("bf16": ``compute_dtype="bfloat16"``, the bf16
streaming path):

1. device: torch and CUDA versions, the card's name and power limit;
2. build: every source in dualvgr_tpu_torch/csrc with nvcc for sm_90a;
3. bilstm: the BiLSTM recurrence kernel against its plain version at the
   three shapes of the flagship forward, with bidirectional torch.nn.LSTM
   (cuDNN, projection included) timed as the library yardstick;
4. gat_cycle: the graph-cycle kernel against its plain version on the
   appearance and the motion stream's inputs, B=256, N=16, D=768, and on
   their first 32 videos (the serving batch), with each shape's launch
   plan (cluster size, clusters, the most videos a cluster takes, CTAs, the
   clusters the card keeps resident and the waves they make, the K split,
   shared memory per CTA checked against the library's own count);
5. eval: the eval forward at the MSRVTT-QA flagship width, batch 256,
   kernel path against plain path, launch counts per forward, QA/s, the
   analytic GFLOP per QA (``utils/flops.py``) and the TFLOP/s it gives;
6. bilstm *_bf16: kernel 1 with bf16 gates at the three shapes of the bf16
   forward and kernels 3 and 4 with bf16 gates at the appearance shape of
   the bf16 train step, against their plain versions;
7. eval bf16: the flagship forward in bf16, kernel routing: launches per
   forward (kernel 6 once on fp32 x, so the tanh pass once, kernel 1 three
   times with bf16 gates, kernel 2 twice, in fp32), ms and QA/s, logits
   against the fp32 kernel path;
7a. gcn, gcn bf16: the same with graph_module GCN (the config's
   default; PunishGCN banks, seed 0): the fp32 forward against its plain
   path, kernel 1 three times a forward and kernel 2 never (checked), ms,
   QA/s, GFLOP per QA and TFLOP/s; the bf16 forward against the fp32 GCN
   forward within the bf16 limits, kernel 6 and its tanh pass once;
8. serve, serve bf16: a BatchingEngine(max_batch=32) around
   build_predict_fn answers 64 concurrent requests at full width, fp32
   then bf16; this is the serving path, whose launches of kernels 1, 2
   (and 6 and the tanh pass in bf16) are counted;
   serve breakdown pageable, serve breakdown pinned: one served batch of
   32 split into host assembly, host-to-device copy, the forward with
   softmax and top-k, and the fetch, with the step before the pinned
   staging (fresh numpy arrays, a copy from pageable memory) and as the engine
   runs it now (pinned staging tensors reused, copies that do not block);
   export, export bf16: the serving program exported with torch.export
   for cuda at max_batch 32 (kernels 1, 2 and 7, or 6 in bf16, as custom ops),
   saved as a .dvgr artifact and loaded back; its graph holds one op node
   per launch and none of the plain versions; the 64 requests through a
   BatchingEngine around the loaded program, against the live predict fn
   (scores within 1e-6), launches per batch those of a forward; export
   and load seconds, artifact size, p50/p99, QA/s;
9. bilstm_train: the trainable recurrence's forward and backward kernels
   (kernels 3 and 4) against their plain versions at the three shapes of
   the flagship train step, with bidirectional torch.nn.LSTM (cuDNN) in
   training mode timed as the yardstick: its forward for kernel 3, its
   backward for kernel 4;
10. train: the train step at the flagship width, batch 256 with the last 6
    rows padded: after 2 warm-up steps, one step's loss and per-module
    gradient norms, kernel path against plain path with dropout off; then
    5 timed steps with dropout on (ms per step, QA/s, losses, peak memory),
    the training path whose launches of kernels 3, 4 and 9 are counted (3
    each per step, none of kernels 1, 2, 5 and 6); one step under the
    profiler;
11. train bf16: the same in bf16, the agreement against the fp32 kernel
    path from the same weights; launches per step: kernel 6 once (no
    tanh), kernels 3, 4 and 9 three times each;
11a. gcn train: phase train on the GCN model (kernels 3 and 4 three times
    a step, the agreement after 2 warm-up steps);
11b. batch_gats: the GAT flagship with the four banks of a graph layer
    stacked (``batch_gats``) against the per-module path from the same
    weights after 2 warm-up steps, dropout off: one train step's loss
    (1e-4 relative) and every gradient (1e-3 of its module's largest), the
    plain eval forward (the eval limits), fwd+bwd and plain eval ms of both;
    the kernel eval of the stacked model still launches kernel 2 twice;
12. proj: the tanh pass (bit for bit against its plain version; ms,
    plain ms, one ``torch.tanh(x, out=bf16)`` call as the library yardstick,
    the bytes bound) and kernel 5 (both time orders) and kernel 6 (on fp32
    x: the tanh pass, then the product; and on bf16 x) against their plain
    versions at R = 4096 (batch 256) and R = 512 (batch 32), bf16 out, with
    the largest difference in bf16 steps and the share of elements that
    differ; ms, plain ms, the library yardsticks (the probe's v0 and v1),
    the bound at the bf16 tensor-core peak, TFLOP/s and the share of the
    bound, and cuBLAS's bf16 GEMM of the same operands for context; then
    the port's probe (``dualvgr_tpu_torch/bench/proj_probe.py``),
    v0-v4, one line, and one call of its v2, whose 2 launches of kernel 5
    (and 2 of the tanh pass) are counted;
12a. proj_f32: kernel 7 at the train cells' shapes (R*T 65,536, 32,768
    and 81,920 rows of D 2,048 into 2 x 1,536 columns): its relative
    Frobenius error against the fp64 product beside torch.baddbmm's in
    fp32 and in TF32 (at most twice fp32's, TF32's beyond that); ms, the
    plain version's ms (the two baddbmm products, bias broadcast and flip
    it replaces), one torch.baddbmm over both directions' columns as the
    library yardstick, the bound (three products at 495 TFLOP/s TF32),
    TFLOP/s, the share of the bound, the SM clock and power under load,
    one launch a call;
12b. wgrad_f32: kernel 8 at the same shapes (the appearance projection's
    dW_ih over K = R*T from dgates (T, R, 2 x 1,536)): its relative
    Frobenius error against the fp64 product beside the library SGEMMs'
    in fp32 and in TF32 (at most twice fp32's, TF32's beyond that); ms,
    the plain version's ms (the two SGEMMs after the transposing copies it
    replaces, which is also the library yardstick), the bound (three
    products at 495 TFLOP/s TF32), TFLOP/s, the share of the bound, the SM
    clock and power under load, one launch a call;
12c. whh_grad_f32: kernel 9 at the appearance BiLSTM's shapes of the same
    cells (dW_hh over K = R*T from hprev (T, R, 2 x 384) and dgates (T, R,
    2 x 1,536)) and at a question BiLSTM's (256 x 24): its relative
    Frobenius error against the fp64 product beside the library SGEMMs' in
    fp32 and in TF32 (at most the fp32 one at the cells' shapes, TF32's
    beyond twice that); ms, the plain version's ms (the two SGEMMs it
    replaces, the library yardstick too), the split count of K, the bound
    (three products at 495 TFLOP/s TF32), TFLOP/s, the share of the bound,
    the SM clock and power under load, one launch a call;
13. cli: the CLIs on an MSRVTT-QA-shaped dataset built in memory at the
    flagship width (384 videos, 805 MB of appearance and 50 MB of motion
    in FeatureStores; 640 training, 256 validation and 300 test
    questions; a YAML config, save_dir in a temporary directory):
    ``dualvgr_tpu_torch.train.train`` for 2 epochs (kernels 3 and 4 three
    times a step, kernels 1 and 2 three and two times a validation
    forward), the metrics_jsonl records, the profiler's trace of epoch
    2; the final state saved and restored on the card (every field bit
    for bit, a step from each within the train limits); then
    ``dualvgr_tpu_torch.validate.run`` on the best checkpoint, kernel
    path against plain path (argmax agreement, each accuracy within the
    disagreeing rows), test_preds.json; the rates through the loader
    beside the model-alone ones (epoch wall time and QA/s, validation
    QA/s, host gather and host-to-device copy per batch, the device's
    busy share over an epoch), the host's CPU count, whether h5py
    imports;
14. cli bf16: the validate CLI with compute and transfer dtype
    bfloat16 on the same checkpoint, its launches, its logits against
    the fp32 kernel path's within the bf16 limits, and its rates;
15. http, http artifact: the HTTP front (``dualvgr_tpu_torch.serve``) on
    the train CLI's checkpoint and the phase's in-memory stores, on
    127.0.0.1: the test split's 300 questions as text from 64 threads of
    a client process,
    the answers against the validate CLI's (top-1 equal except near
    ties), /healthz, /stats, a 404 and a 400; the checkpoint exported
    for cuda and served from the artifact, against the checkpoint route;
    the export phase's artifact over the same front, against its own
    predict fn; p50/p99, QA/s, launches per batch those of a forward;
16. gcn cli: phase cli's dataset under a config without ``graph_module``
    (so GCN): the train CLI for 1 epoch and the validate CLI (launches
    checked: no kernel 2), ``graph_module: GCN`` in model_kwargs.json; the
    checkpoint exported for cuda (three ``bilstm_recurrence`` nodes, no
    ``gat_cycle``) and phase serve's 64 requests through the loaded artifact
    against the live program (scores within 1e-6, top-1 equal except on
    ties);
17. zoo: every class of the zoos (decoder and question-encoder variants,
    graph, attention and model-utils zoos, fusions) once on CUDA tensors at
    a small width against the same module on the CPU, within 1e-5 of the
    largest output, no CPU tensor made on the way (``bench/zoo_check.py``);
18. extract, extract bf16 (after proj): ResNet-101 at 224^2 on 1024 frames
    (4 videos x 16 clips x 16 frames) and ResNeXt-101 3D on 64 clips of 16
    x 112^2, seeded weights and pixels: ms, frames/s, clips/s, videos/s,
    the analytic GFLOP per frame and clip (``utils/flops.py``), TFLOP/s
    and the bound at the fp32 (no TF32) or bf16 peak; the fp32 features of
    the first 8 frames and 4 clips against the port on the CPU (1e-4 x
    max|ref|); bf16 against fp32 (relative norm error < 0.02, per-row
    cosine > 0.995); each grouped conv shape of the motion network as
    cuDNN's grouped conv and as a dense conv with the block-diagonal
    weight, in turns (within 1e-4 x max|ref| in fp32, one bf16 step of it
    in bf16);
19. native gather (the end of phase cli): a batch of 256 appearance rows
    of phase cli's store gathered into one pinned tensor by the native
    gather at 1, 2, 4 and 8 threads and by ``torch.index_select``, in
    turns, bit-equal; the batch's fp32 -> bf16 cast, native against torch;
    the training epoch through the loader with ``num_workers`` 8 against
    the index_select gather, in turns;
20. predict (after cli bf16): 8 videos of seeded uint8 frames (96 of 240 x
    320) and a question each through ``predict.predict_frames`` (resize on
    the card, both fp32 backbones, one DualVGR forward of phase cli's
    checkpoint): kernel 1 three times and kernel 2 twice in that run, the
    logits against the plain path on the same features, the top 5, and
    the ms of each stage (resize, appearance, motion, DualVGR) and of the
    whole per video;
21. nccl two ranks, ddp, ddp bf16, tp (after batch_gats;
    ``parallel/dryrun.py``): the error NCCL gives for two ranks on one
    card (printed, not checked: a later NCCL may accept them); then two
    ranks sharing the card in a gloo group (NCCL refuses two ranks on one
    device; gloo stages each collective through the host), phase train's
    global batch of 256, 128 rows a rank: three data-parallel steps and a
    validation forward against one process on the same global batch
    (losses 1e-4 relative, module gradient norms 1e-3 at the last step,
    the parameter checksum 1e-4, every parameter within one Adam step a
    step, the argmax >= 0.99), kernels 3 and 4 three times a step and
    kernels 1 and 2 three and two times a forward, kernels 7 and 8 once a
    step and kernel 7 once a forward on each rank, step ms
    per rank and the gradient's all-reduce ms; the same steps in bf16
    (kernel 6 once a step, the bf16 limits against the fp32 DP steps);
    ``tensor_parallel: 2`` (with and without ``zero_opt``) on a (1, 2)
    mesh: no launch, the kernels' warning logged, leaves sharded over the
    model axis, the loss within 1e-4 of the DP step's; a DP step with
    ZeRO-1; the bytes of parameters and Adam state a rank holds in each
    layout;
22. ddp nccl (after cli): the train CLI in a one-rank NCCL group with
    the environment ``torchrun --nproc_per_node 1`` sets, on phase cli's
    dataset: its launches phase cli's, the validate CLI's predictions on
    its best checkpoint against phase cli's (argmax agreement >= 0.99),
    its final state saved (gathered, rank 0 writing) and restored bit for
    bit.

Kernels 1, 3 and 4 (phases bilstm, bilstm *_bf16, bilstm_train) print, per
shape, their launch plan (cluster size, the clusters the card keeps
resident and those launched, the SMs left idle, shared memory per CTA,
checked against the library's own count, rows per tile, items per
cluster) and, as per_block_recorded_ms, their time before the cluster
redesign as PERF.md records it (not measured by this run); kernel 4 also
its registers and spills as ptxas reported them; at the appearance shape,
the SM clock, power draw and power limit that ``nvidia-smi`` reads while
kernel 1 or 3 runs back to back.
Then one JSON line with the kernel table (with each row's launches in
the GCN phases, ``launches_gcn*``, kernel 2's in the stacked model's
kernel eval, ``launches_batch_gats_eval``, kernels 1 and 2's in phase
predict, ``launches_predict``, and each kernel's on one rank of phase ddp,
``launches_ddp``, ``launches_ddp_eval``, ``launches_ddp_bf16``, and in
phase ddp nccl, ``launches_ddp_nccl``) and, last, the device line. Any
failed check raises, and the script exits nonzero. Weights come from the
port's own seeded init. TF32 is switched off for matmuls and for cuDNN, so
the fp32 paths, the plain versions and the yardsticks are fp32.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from dualvgr_tpu_torch import (
    BatchingEngine, build_model, build_predict_fn, create_train_state, make_optimizer, pred_step, train_step,
    validate_lib,
)
from dualvgr_tpu_torch import train as ttrain
from dualvgr_tpu_torch import validate as tvalidate
from dualvgr_tpu_torch import predict as tpredict
from dualvgr_tpu_torch.bench import extraction_bench, proj_probe
from dualvgr_tpu_torch.bench.proj_kernel_ab import (
    baddbmm_errors, clocks_under_load, f32_inputs, fp64_product, fp64_wgrad, fp64_whh, rel_error, sgemm_errors,
    wgrad_inputs, whh_inputs, whh_sgemm_errors,
)
from dualvgr_tpu_torch.bench.timing import time_ms
from dualvgr_tpu_torch.bench.zoo_check import TOL as TOL_ZOO
from dualvgr_tpu_torch.bench.zoo_check import check_zoo
from dualvgr_tpu_torch.config import cfg_from_file, resolve_dataset_paths
from dualvgr_tpu_torch.data import FeatureStore, native
from dualvgr_tpu_torch.data.questions import encode_tokens, tokenize_question
from dualvgr_tpu_torch.data.vocab import load_vocab
from dualvgr_tpu_torch.export import export_serving, graph_ops, load_artifact, model_from_checkpoint, save_artifact
from dualvgr_tpu_torch.ops import COUNTED_KERNELS, _build, launch_counts
from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops import gat_kernel, proj_kernel, whh_grad_kernel
from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle, gat_cycle_reference
from dualvgr_tpu_torch.ops.lstm import time_major_input_proj
from dualvgr_tpu_torch.ops.lstm_kernel import (
    active_clusters, backward_plan, bilstm_recurrence, bilstm_recurrence_reference, gate_dtype_code, launch_plan,
    library_smem_bytes, recurrence_plan,
)
from dualvgr_tpu_torch.ops.lstm_train_kernel import (
    bilstm_train_bwd, bilstm_train_bwd_reference, bilstm_train_fwd, bilstm_train_fwd_reference,
)
from dualvgr_tpu_torch.ops.proj_kernel import (
    input_proj_both, input_proj_both_reference, input_proj_f32, input_proj_f32_reference, input_proj_f32_wgrad,
    input_proj_f32_wgrad_reference, input_proj_one, input_proj_one_reference, tanh_to_bf16, tanh_to_bf16_reference,
)
from dualvgr_tpu_torch.ops.whh_grad_kernel import whh_grad_f32, whh_grad_f32_reference, whh_grad_plan
from dualvgr_tpu_torch.parallel.mesh import prefetch_to_device
from dualvgr_tpu_torch.preprocess.features import (
    build_appearance_extractor, build_motion_extractor, clips_from_frames,
)
from dualvgr_tpu_torch import serve as tserve
from dualvgr_tpu_torch.serving import Request, ServingProgram
from dualvgr_tpu_torch.train import model_kwargs_tosave
from dualvgr_tpu_torch.train_lib import forward_backward
from dualvgr_tpu_torch.utils.checkpoint import load_model_kwargs, restore_checkpoint, save_checkpoint
from dualvgr_tpu_torch.utils.flops import dualvgr_forward_flops

FLAGSHIP = dict(
    vision_dim=2048, module_dim=768, word_dim=300, question_vocab_size=8000,
    num_answers=4000, num_of_nodes=16, graph_layers=1, unit_layers=1,
)
BATCH, CLIPS, FRAMES, QLEN = 256, 16, 16, 24
SERVE_BATCH, SERVE_REQUESTS, TOP_K = 32, 64, 5
# the train step: the last rows of the batch padded out (valid = 0), the
# CLI's loss weights (train.py), the shipped config's learning rate
TRAIN_PAD, ALPHA, BETA = 6, 1.0, 1e-8
TRAIN_CFG = "configs/msrvtt_qa_DualVGR_16.yml"
WARMUP_STEPS, TIMED_STEPS = 2, 5
# H100 SXM published peaks: fp32 outside the tensor cores, dense bf16 on
# the tensor cores (kernels 5 and 6), dense TF32 on them (kernels 7, 8 and
# 9's three products), and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
BF16 = torch.bfloat16
PROJ_ROWS = (BATCH * CLIPS, SERVE_BATCH * CLIPS)  # the projection's R at batch 256 and 32
# kernels 7 and 8's R at the train cells (batch 256 x 16, 8 and 20 clips of 16 frames)
PROJ_F32_ROWS = {"msrvtt-qa": BATCH * 16, "msvd-qa": BATCH * 8, "svqa": BATCH * 20}
# kernel 9's (R, T) at the train cells' appearance BiLSTMs and at a question BiLSTM
WHH_SHAPES = {**{cell: (rows, FRAMES) for cell, rows in PROJ_F32_ROWS.items()}, "question": (BATCH, QLEN)}
# tolerances, fp32 without TF32:
#   recurrence: 16-24 steps of tanh/sigmoid-bounded states; only the sum
#   order of the 384-long products differs -> 1e-4 absolute
#   graph cycle: four 768-long fp32 products in another order, relative to
#   the largest value -> 1e-3 * max(1, max|ref|)
#   logits: the whole stack in another order -> 1e-3 * max|logits|, and
#   the argmax may flip only on near-ties -> agreement >= 0.99
#   training backward: gradients carried back over 16-24 steps through a
#   384-long and a 1536-long product per step -> 1e-3 * max(1, max|ref|)
#   train step, kernel path against plain path: the loss within 1e-4
#   relative, each top-level module's gradient norm within 1e-3 relative
TOL_LSTM = 1e-4
TOL_GAT = 1e-3
TOL_LOGITS = 1e-3
MIN_ARGMAX_AGREEMENT = 0.99
TOL_LSTM_BWD = 1e-3
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GNORM = 1e-3
# bf16 streaming:
#   bf16 outputs (kernels 5 and 6, kernel 1 with bf16 gates) against their
#   plain versions: a sum in another order may cross a bf16 rounding
#   boundary, so one bf16 step of the reference's magnitude, plus the fp32
#   tolerance for values near zero (1e-5 for the projection's sums, TOL_LSTM
#   for the recurrence)
#   the bf16 paths against the fp32 kernel path: the CPU tests measured the
#   JAX package's bf16-vs-fp32 gap (tests/test_torch_model_bf16.py,
#   tests/test_torch_train_bf16.py) at up to 1.2% of max|logit| in the
#   logits, 0.13% in the loss and 2.2% in a module's gradient norm at
#   module_dim 16; the limits are 4x those: logits within 5e-2 * max|logit|,
#   the loss within 5e-3 relative, each module's gradient norm within 1e-1
#   relative. An argmax may differ only on a row whose fp32 top-2 margin is
#   within twice the largest logit difference.
TOL_BF16_PROJ_ATOL = 1e-5
#   kernels 5 and 6: a sum in another order crosses a bf16 rounding
#   boundary on about 1e-3 of the elements (9.1e-4 to 9.5e-4 measured); at
#   most 2e-3 of them may differ, so an error that stays within one step
#   everywhere but is systematic still fails
TOL_BF16_PROJ_SHARE = 2e-3
TOL_BF16_LOGITS = 5e-2
TOL_BF16_TRAIN_LOSS = 5e-3
TOL_BF16_TRAIN_GNORM = 1e-1


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def bound_ms(flops, nbytes, peak_flops=PEAK_FP32_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# kernels 1 and 3 per shape in the design before the clusters (one block
# per row tile and direction, W_hh streamed from L2 every step), as PERF.md
# records them (this script, H100 80GB HBM3 at 700 W); printed in the phase
# lines as per_block_recorded_ms, never in the kernels line, which holds
# only this run's measurements
PER_BLOCK_RECORDED_MS = {
    "bilstm_recurrence": {"appearance": 6.38, "question_outputs": 1.48, "question_final": 1.49,
                          "appearance_bf16": 6.57, "question_outputs_bf16": 1.48, "question_final_bf16": 1.49},
    "bilstm_train_fwd": {"appearance": 7.40, "question_outputs": 1.54, "question_final": 1.54,
                         "appearance_bf16": 6.62},
    "bilstm_train_bwd": {"appearance": 17.57, "question_outputs": 2.69, "question_final": 2.66,
                         "appearance_bf16": 15.43},
}
# the compiler's report of each source built by this run (phase build)
BUILD_REPORTS: dict = {}


def cluster_plan(prefix, gates):
    """The launch plan kernel ``prefix`` (1, 3 or 4) takes for ``gates``
    (T, R, 4H): cluster size, the clusters the card keeps resident, the
    clusters launched, the SMs they leave idle, shared memory per CTA
    (checked against the library's own count), rows per tile and the most
    items a cluster walks."""
    _, r, g = gates.shape
    # kernel 4 reads fp32 activations whatever the gates: it has no gate type
    code = None if prefix == "bilstm_train_bwd" else gate_dtype_code(prefix, gates)
    plan = launch_plan(prefix, r, g // 4, code,
                       plan=backward_plan if prefix == "bilstm_train_bwd" else recurrence_plan)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smem = library_smem_bytes(prefix, g // 4)
    check(smem == plan.smem_bytes,
          f"{prefix}: the plan's {plan.smem_bytes} bytes of shared memory, the build's {smem}")
    return dict(cluster=plan.cluster, active_clusters=active_clusters(prefix, g // 4, code),
                clusters=plan.clusters, idle_sms=sms - plan.cluster * plan.clusters,
                smem_bytes=smem, rows_per_tile=plan.rows_per_tile,
                items_per_cluster=plan.tiles_per_cluster)


def ptxas_summary(source):
    """Registers and spill stores of each kernel in ``source`` as ptxas
    reported them when this run built it."""
    lines = [ln.strip() for ln in BUILD_REPORTS.get(source, "").splitlines() if "Used" in ln or "spill" in ln]
    return " | ".join(lines) or "not built by this run"


def fmt_plan(plan):
    return ",".join(f"{k}:{v}" for k, v in plan.items())


def under_load(fn):
    """``nvidia-smi``'s SM clock, power draw and power limit while ``fn``
    runs back to back for a second (medians past the ramp)."""
    return dict(zip(("sm_mhz", "power_w", "limit_w"), clocks_under_load(fn)))


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_bf16(name, got, want, atol):
    """bf16 outputs against their plain version: within one bf16 step of
    the reference plus ``atol``. Returns (max abs err, largest difference in
    bf16 steps after ``atol``, share of elements that differ)."""
    check(got.dtype == want.dtype == BF16 and got.shape == want.shape, f"{name}: dtype or shape")
    check(torch.isfinite(got.float()).all().item(), f"{name}: non-finite kernel output")
    steps, share, ok = proj_probe.compare(got, want, atol)
    err = max_err(got, want)
    check(ok, f"{name}: {steps:.2f} bf16 steps beyond {atol} (max abs err {err:.3e})")
    return err, steps, share


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count())
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    secs, reports = _build.build_all()
    BUILD_REPORTS.update(reports)
    say("build", seconds=f"{secs:.2f}", compiled=sorted(reports))
    for src, text in reports.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line or "Performance Loss" in line:
                print(f"  {src}: {line.strip()}", flush=True)
    # the projections' shared memory is dynamic, which ptxas does not report
    print(f"  input_proj.cu: input_proj_kernel dynamic shared memory {proj_kernel.library_smem_bytes()} bytes",
          flush=True)
    print(f"  input_proj_f32.cu: input_proj_f32_kernel dynamic shared memory "
          f"{proj_kernel.f32_library_smem_bytes()} bytes", flush=True)
    print(f"  wgrad_f32.cu: wgrad_f32_kernel dynamic shared memory "
          f"{proj_kernel.f32_wgrad_library_smem_bytes()} bytes", flush=True)
    print(f"  whh_grad_f32.cu: whh_grad_kernel dynamic shared memory "
          f"{whh_grad_kernel.library_smem_bytes()} bytes", flush=True)


def flagship_inputs(batch, gen):
    dev = gen.device
    app = torch.randn((batch, CLIPS, FRAMES, FLAGSHIP["vision_dim"]), generator=gen, device=dev)
    mot = torch.randn((batch, CLIPS, FLAGSHIP["vision_dim"]), generator=gen, device=dev)
    qlen = torch.randint(4, QLEN + 1, (batch,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randint(1, FLAGSHIP["question_vocab_size"], (batch, QLEN), generator=gen, device=dev,
                      dtype=torch.int32)
    q = q * (torch.arange(QLEN, device=dev)[None, :] < qlen[:, None])
    return app, mot, q.to(torch.int32), qlen


def lstm_case(name, enc, x, lengths, with_outputs, gates=None):
    """Kernel vs plain recurrence on the projections of one BiLSTM of the
    model, plus torch.nn.LSTM on the same rows as the yardstick; with
    ``gates`` (bf16 xf, xb_rev) the bf16-gate variant, outputs in bf16, no
    yardstick."""
    fwd, bwd = enc._params(""), enc._params("_reverse")
    if gates is None:
        xf = time_major_input_proj(x, fwd)
        xb = time_major_input_proj(x, bwd, reverse=True)
    else:
        xf, xb = gates
    whf, whb = fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous()
    args = (xf, xb, whf, whb, lengths)
    got = bilstm_recurrence(*args, with_outputs=with_outputs)
    torch.cuda.synchronize()
    want = bilstm_recurrence_reference(*args, with_outputs=with_outputs)
    got, want = (got, want) if with_outputs else ((got,), (want,))
    if gates is None:
        errs = [max_err(g, w) for g, w in zip(got, want)]
        check(all(torch.isfinite(g).all().item() for g in got), f"{name}: non-finite kernel output")
        check(max(errs) <= TOL_LSTM, f"{name}: kernel vs plain max abs err {errs} > {TOL_LSTM}")
    else:
        errs = [check_bf16(f"bilstm {name}", g, w, TOL_LSTM)[0] for g, w in zip(got, want)]

    ms = time_ms(lambda: bilstm_recurrence(*args, with_outputs=with_outputs), 10)
    plain_ms = time_ms(lambda: bilstm_recurrence_reference(*args, with_outputs=with_outputs), 3)
    plan = cluster_plan("bilstm_recurrence", xf)
    if name.startswith("appearance"):
        say(f"bilstm {name} under load", **under_load(lambda: bilstm_recurrence(*args, with_outputs=with_outputs)))
    t_total, r, g = xf.shape
    h = g // 4
    # what these inputs need: a padded step leaves the state as it was, so
    # each direction runs len_r steps of row r, each an (H) @ (H, 4H)
    # product reading that step's 4H gates
    steps = t_total * r if lengths is None else int(lengths.sum().item())
    gb = xf.element_size()  # bytes per gate and per output
    flops = 2 * steps * 2 * h * g
    nbytes = gb * 2 * steps * g + 4 * 2 * whf.numel() + gb * r * 2 * h
    if lengths is not None:
        nbytes += 4 * r
    if with_outputs:
        nbytes += gb * r * t_total * 2 * h
    bms, by = bound_ms(flops, nbytes)
    if gates is not None:
        say(f"bilstm {name}", T=t_total, R=r, H=h, gates="bf16", masked=lengths is not None,
            outputs=with_outputs, max_abs_err=f"{max(errs):.3e}", tol=f"1 bf16 step + {TOL_LSTM}",
            ms=f"{ms:.4f}", per_block_recorded_ms=PER_BLOCK_RECORDED_MS["bilstm_recurrence"][name],
            plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by, plan=fmt_plan(plan))
        return dict(shape=name, err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms, flops=flops,
                    bytes=nbytes, plan=plan)

    lstm = torch.nn.LSTM(x.shape[-1], h, batch_first=True, bidirectional=True).to(x.device)
    with torch.no_grad():
        for sfx, p in (("", fwd), ("_reverse", bwd)):
            for k, v in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"), p):
                getattr(lstm, k + sfx).copy_(v)
    if lengths is None:
        lib_in = x
    else:
        lib_in = torch.nn.utils.rnn.pack_padded_sequence(
            x, lengths.cpu().long(), batch_first=True, enforce_sorted=False
        )
    with torch.no_grad():
        library_ms = time_ms(lambda: lstm(lib_in), 5)
    say(f"bilstm {name}", T=t_total, R=r, H=h, masked=lengths is not None, outputs=with_outputs,
        max_abs_err=f"{max(errs):.3e}", tol=TOL_LSTM, ms=f"{ms:.4f}",
        per_block_recorded_ms=PER_BLOCK_RECORDED_MS["bilstm_recurrence"][name], plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by, plan=fmt_plan(plan))
    return dict(shape=name, err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, flops=flops, bytes=nbytes, plan=plan)


@torch.no_grad()
def phase_bilstm(model, app, q, qlen):
    """The recurrence at the three shapes of one flagship forward: the
    appearance encoder (final only, unmasked), concatRNN (masked, outputs)
    and the question encoder (masked, final only)."""
    words = torch.tanh(model.linguistic_input_unit.encoder_embed(q))
    b, c, f, d = app.shape
    clips = torch.tanh(app).reshape(b * c, f, d)
    cases = [
        lstm_case("appearance", model.visual_appearance_input_unit.encoder, clips, None, False),
        lstm_case("question_outputs", model.linguistic_input_unit.concatRNN.rnn, words, qlen, True),
        lstm_case("question_final", model.linguistic_input_unit.encoder, words, qlen, False),
    ]
    del clips
    torch.cuda.empty_cache()
    return cases


def gat_case(name, h, scores, args):
    """Kernel vs plain cycle on one stream's inputs."""
    got = gat_cycle(h, scores, *args)
    torch.cuda.synchronize()
    want = gat_cycle_reference(h, scores, *args)
    errs, tols = [], []
    for field, g, w in zip(("out", "common", "spec"), got, want):
        check(torch.isfinite(g).all().item(), f"gat_cycle {name} {field}: non-finite")
        errs.append(max_err(g, w))
        tols.append(TOL_GAT * max(1.0, w.abs().max().item()))
        check(errs[-1] <= tols[-1], f"gat_cycle {name} {field}: max abs err {errs[-1]:.3e} > {tols[-1]:.3e}")
    ms = time_ms(lambda: gat_cycle(h, scores, *args), 20)
    plain_ms = time_ms(lambda: gat_cycle_reference(h, scores, *args), 5)
    b, n, d = h.shape
    heads = args[2].shape[0]
    plan = gat_kernel.card_plan(b, n, d, heads)
    smem = gat_kernel.library_smem_bytes(b, n, d, heads, plan)
    check(smem == plan.smem_bytes, f"gat_cycle {name}: the plan's {plan.smem_bytes} bytes of shared memory, "
                                   f"the build's {smem}")
    plan = dict(cluster=plan.cluster, clusters=plan.clusters, videos_per_cluster=plan.videos_per_cluster,
                ctas=plan.ctas, active_clusters=gat_kernel.active_clusters(b, n, d, heads, plan),
                waves=round(plan.waves, 3), tile_rows=plan.tile_rows, k_split=plan.k_split, smem_bytes=smem)
    flops = 8 * b * n * d * d + 4 * b * n * n * d + 8 * b * n * d
    score_bytes = 4 * b * n  # the broadcast view holds one float per clip
    nbytes = 4 * (h.numel() + 3 * d * d + 4 * d + 4 * heads * (d // heads) + 2 * heads) \
        + score_bytes + 4 * 3 * h.numel()
    bms, by = bound_ms(flops, nbytes)
    say(f"gat_cycle {name}", B=b, N=n, D=d, heads=heads, err_out=f"{errs[0]:.3e}",
        err_common=f"{errs[1]:.3e}", err_spec=f"{errs[2]:.3e}", tol=f"{TOL_GAT}*max(1,max|ref|)",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by, plan=fmt_plan(plan))
    return dict(shape=name, err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms, flops=flops,
                bytes=nbytes, plan=plan)


@torch.no_grad()
def phase_gat(model, app, mot, q, qlen):
    """The cycle on both streams' real inputs at batch 256, as one flagship
    forward launches it, then on their first SERVE_BATCH videos, as a
    served batch launches it. Returns (batch 256 cases, serving cases)."""
    _, words, dynamic = model.linguistic_input_unit(q, qlen, use_kernel=False)
    h_app = model.visual_appearance_input_unit(app, use_kernel=False)
    h_mot = model.visual_motion_input_unit(mot)
    vu = model.visual_input_unit
    guided, _ = vu.queryAttn[0](words, dynamic, qlen)
    # the scores are broadcast views, one score per clip
    streams = [
        ("appearance", h_app, vu.queryPunish_appear[0](guided, h_app),
         (*vu.acGCN[0].merged(), *vu.appearance_GCN[0].merged(), *vu.attention_appearance[0].merged())),
        ("motion", h_mot, vu.queryPunish_motion[0](guided, h_mot),
         (*vu.mcGCN[0].merged(), *vu.motion_GCN[0].merged(), *vu.attention_motion[0].merged())),
    ]
    full = [gat_case(name, h, scores, args) for name, h, scores, args in streams]
    serving = [gat_case(f"{name}_b{SERVE_BATCH}", h[:SERVE_BATCH], scores[:SERVE_BATCH], args)
               for name, h, scores, args in streams]
    return full, serving


# launches per fp32 forward and per bf16 forward (kernels 1-6, the tanh
# pass, which kernel 6 runs on fp32 x, then kernel 7, the fp32 appearance
# projection, kernel 8, its weight gradient, and kernel 9, the BiLSTMs'
# recurrent weight gradient); a GCN model never runs kernel 2
EVAL_LAUNCHES = {"float32": (3, 2, 0, 0, 0, 0, 0, 1, 0, 0), "bfloat16": (3, 2, 0, 0, 0, 1, 1, 0, 0, 0)}
GCN_EVAL_LAUNCHES = {"float32": (3, 0, 0, 0, 0, 0, 0, 1, 0, 0), "bfloat16": (3, 0, 0, 0, 0, 1, 1, 0, 0, 0)}
# launches per train step: kernels 7 and 8 once each in fp32, kernel 6 (on
# bf16 x, no tanh pass) once in bf16, kernel 9 once a trainable BiLSTM in
# both (its operands are fp32 in both)
TRAIN_LAUNCHES = {"float32": (0, 0, 3, 3, 0, 0, 0, 1, 1, 3), "bfloat16": (0, 0, 3, 3, 0, 1, 0, 0, 0, 3)}


def reset_counts():
    for k in COUNTED_KERNELS:
        k.launches = 0


def flops_per_qa(model):
    """The analytic matmul FLOPs of one flagship forward per QA pair
    (``utils/flops.py``; graph layers counted as PunishGAT's)."""
    vu = model.visual_input_unit
    return dualvgr_forward_flops(
        vision_dim=FLAGSHIP["vision_dim"], module_dim=FLAGSHIP["module_dim"], word_dim=FLAGSHIP["word_dim"],
        num_answers=FLAGSHIP["num_answers"], num_of_nodes=CLIPS, frames_per_clip=FRAMES, q_len=QLEN,
        unit_layers=vu.unit_layers, graph_layers=vu.graph_layers,
    )


@torch.no_grad()
def phase_eval(model, app, mot, q, qlen, tag="eval", want=EVAL_LAUNCHES["float32"]):
    """The fp32 forward, kernel path against plain path; ``want`` the
    launches of one forward. Returns (ms, logits, launches)."""
    model.use_kernels = True
    reset_counts()
    out = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    launches = launch_counts()
    n_lstm, n_gat = launches[:2]
    check(launches == want, f"one {tag} forward launched {launches} kernels, want {want}")
    model.use_kernels = False
    ref = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    logits, ref_logits = out.logits, ref.logits
    check(tuple(logits.shape) == (BATCH, FLAGSHIP["num_answers"]), f"logits shape {tuple(logits.shape)}")
    for field in out._fields:
        check(torch.isfinite(getattr(out, field)).all().item(), f"non-finite {field}")
    scale = ref_logits.abs().max().item()
    err = max_err(logits, ref_logits)
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
    check(err <= TOL_LOGITS * scale, f"logits max abs err {err:.3e} > {TOL_LOGITS} * {scale:.3e}")
    check(agree >= MIN_ARGMAX_AGREEMENT, f"argmax agreement {agree} < {MIN_ARGMAX_AGREEMENT}")
    aux = {}
    for field in out._fields[1:]:
        a, r = getattr(out, field), getattr(ref, field)
        aux[field] = max_err(a, r)
        tol = TOL_GAT * max(1.0, r.abs().max().item())
        check(aux[field] <= tol, f"{field} max abs err {aux[field]:.3e} > {tol:.3e}")
    plain_ms = time_ms(lambda: model(app, mot, q, qlen), 3)
    model.use_kernels = True
    ms = time_ms(lambda: model(app, mot, q, qlen), 5)
    flops = flops_per_qa(model)
    say(tag, graph_module=model.visual_input_unit.graph_module, batch=BATCH, logits_max_abs_err=f"{err:.3e}",
        max_abs_logit=f"{scale:.3e}", argmax_agreement=f"{agree:.4f}", aux_max_abs_err=f"{max(aux.values()):.3e}",
        launches_per_forward=f"bilstm_recurrence:{n_lstm},gat_cycle:{n_gat},input_proj_f32:{launches[7]}",
        forward_ms=f"{ms:.3f}", qa_per_s=f"{BATCH / ms * 1e3:.1f}",
        plain_forward_ms=f"{plain_ms:.3f}", plain_qa_per_s=f"{BATCH / plain_ms * 1e3:.1f}",
        gflop_per_qa=f"{flops / 1e9:.4f}", tflop_per_s=f"{flops * BATCH / ms / 1e9:.2f}")
    profile_run("profile" if tag == "eval" else f"{tag} profile", lambda: model(app, mot, q, qlen))
    return ms, logits, launches


def profile_run(phase, fn, top=8):
    """Device time by kernel over one call of ``fn`` (torch.profiler), and
    the share of the call's device time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        end.synchronize()
    wall_us = start.elapsed_time(end) * 1e3
    # kernel rows only: a CPU op's row repeats the device time of its kernels
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    if not rows:
        say(phase, device_time="not measured (the profiler recorded no device time)")
        return
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    say(phase, wall_us=f"{wall_us:.0f}", kernel_us=f"{busy_us:.0f}",
        busy_share=f"{busy_us / wall_us:.3f}")
    for name, us, count in rows[:top]:
        print(f"  {us:10.0f} us {us / busy_us:6.1%} x{count:<4d} {name[:90]}", flush=True)


def serve_requests():
    """The serving phases' 64 requests at full width: features and questions
    of 4-24 tokens from seed 1."""
    rng = np.random.RandomState(1)
    vd = FLAGSHIP["vision_dim"]
    return [
        (rng.randn(CLIPS, FRAMES, vd).astype(np.float32), rng.randn(CLIPS, vd).astype(np.float32),
         rng.randint(1, FLAGSHIP["question_vocab_size"], (4 + i % (QLEN - 3),)).astype(np.int32))
        for i in range(SERVE_REQUESTS)
    ]


def direct_answers(predict, reqs):
    """``reqs`` straight through ``predict`` in batches of the engine's size:
    the answers to hold an engine's against (and a warm-up)."""
    direct = []
    for s in range(0, len(reqs), SERVE_BATCH):
        chunk = reqs[s : s + SERVE_BATCH]
        q = np.zeros((len(chunk), QLEN), np.int32)
        for i, r in enumerate(chunk):
            q[i, : len(r[2])] = r[2]
        ids, scores = predict(np.stack([r[0] for r in chunk]), np.stack([r[1] for r in chunk]), q,
                              np.array([len(r[2]) for r in chunk], np.int32))
        direct += list(zip(ids, scores))
    torch.cuda.synchronize()
    return direct


def serve_through_engine(tag, predict, reqs, direct, compute_dtype, per_batch=None):
    """``reqs`` from concurrent threads through a BatchingEngine around
    ``predict``: every answer within 1e-6 of ``direct`` (top-1 ids equal
    except where the top two scores tie), the launches of kernels 1, 2
    and 6 per batch ``per_batch`` (by default those of a GAT forward in
    ``compute_dtype``). Returns (launches, stats, wall s)."""
    vd = FLAGSHIP["vision_dim"]
    results = [None] * len(reqs)
    errors = []

    def call(i):
        try:
            results[i] = eng.submit(*reqs[i], timeout=120.0)
        except Exception as e:  # noqa: BLE001 — recorded and checked below
            errors.append(repr(e))

    with BatchingEngine(predict, max_batch=SERVE_BATCH, max_wait_ms=5.0, max_q_len=QLEN,
                        feature_shapes=((CLIPS, FRAMES, vd), (CLIPS, vd))) as eng:
        reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        stats = eng.stats()
    check(not errors, f"{tag} errors: {errors[:3]}")
    check(all(r is not None for r in results), f"{tag}: a request got no answer")
    check(stats["requests"] == len(reqs), f"{tag}: engine counted {stats['requests']} requests")
    want = tuple(n * stats["batches"] for n in (per_batch or EVAL_LAUNCHES[compute_dtype]))
    check(launches == want, f"{tag} launched {launches} kernels over {stats['batches']} batches, want {want}")
    for i, ((got_ids, got_scores), (ids, scores)) in enumerate(zip(results, direct)):
        check(got_ids.shape == (TOP_K,) and np.isfinite(got_scores).all(), f"{tag} request {i}: bad answer")
        check(np.allclose(got_scores, scores, atol=1e-6), f"{tag} request {i}: scores differ from direct")
        # the top-1 id may differ only where the top two scores tie
        check(got_ids[0] == ids[0] or scores[0] - scores[1] <= 1e-6, f"{tag} request {i}: other top-1")
    return launches, stats, wall


def fmt_launches(launches):
    return (f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]},input_proj_both:{launches[5]},"
            f"tanh_to_bf16:{launches[6]},input_proj_f32:{launches[7]}")


def phase_serve(model, tag="serve"):
    """The main path: concurrent requests through the engine, in the
    model's compute dtype; the launches of kernels 1, 2 and 6 counted."""
    reqs = serve_requests()
    predict = build_predict_fn(model, TOP_K)
    direct = direct_answers(predict, reqs)
    launches, stats, wall = serve_through_engine(tag, predict, reqs, direct, model.compute_dtype)
    say(tag, requests=stats["requests"], batches=stats["batches"],
        mean_batch=f"{stats['mean_batch']:.2f}", p50_ms=f"{stats['latency_ms_p50']:.2f}",
        p99_ms=f"{stats['latency_ms_p99']:.2f}", qa_per_s=f"{SERVE_REQUESTS / wall:.1f}",
        launches=fmt_launches(launches))
    return launches


# the exported graph: one op node per launch of a forward, and none of the
# plain versions' signatures (the graph cycle's LeakyReLU, the LSTM cell's chunk)
EXPORT_OPS = {"float32": {"bilstm_recurrence": 3, "gat_cycle": 2, "input_proj_f32": 1},
              "bfloat16": {"bilstm_recurrence": 3, "gat_cycle": 2, "input_proj_both": 1}}
PLAIN_SIGNATURES = ("aten.leaky_relu.default", "aten.chunk.default")


def phase_export(model, root, tag="export"):
    """The serving program of ``model`` exported for cuda at max_batch 32,
    saved, loaded back and its graph checked; the serving phase's 64
    requests through a BatchingEngine around the loaded program, held
    against the live ``build_predict_fn``. Returns (launches, path)."""
    vd, dtype = FLAGSHIP["vision_dim"], model.compute_dtype
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payload, meta = export_serving(model, max_batch=SERVE_BATCH, app_shape=(CLIPS, FRAMES, vd),
                                   mot_shape=(CLIPS, vd), max_q_len=QLEN, top_k=TOP_K, platforms=("cuda",))
    export_s = time.perf_counter() - t0
    path = os.path.join(root, f"{tag.replace(' ', '_')}.dvgr")
    save_artifact(path, payload, meta)
    del payload
    t0 = time.perf_counter()
    predict, _ = load_artifact(path)
    load_s = time.perf_counter() - t0
    ops = graph_ops(predict.program)
    want = {f"dualvgr_torch.{k}.default": n for k, n in EXPORT_OPS[dtype].items()}
    kernel_ops = {k: n for k, n in ops.items() if k.startswith("dualvgr_torch.")}
    check(kernel_ops == want, f"{tag}: the graph holds {kernel_ops}, want {want}")
    check(not any(ops[k] for k in PLAIN_SIGNATURES), f"{tag}: the graph holds a plain version "
                                                     f"({ {k: ops[k] for k in PLAIN_SIGNATURES} })")
    reqs = serve_requests()
    direct = direct_answers(build_predict_fn(model, TOP_K), reqs)
    direct_answers(predict, reqs[:SERVE_BATCH])  # warm the loaded program
    launches, stats, wall = serve_through_engine(tag, predict, reqs, direct, dtype)
    say(tag, export_s=f"{export_s:.2f}", load_s=f"{load_s:.2f}", artifact_mb=f"{os.path.getsize(path) / 1e6:.1f}",
        graph_ops=",".join(f"{k.split('.')[1]}:{n}" for k, n in sorted(kernel_ops.items())),
        graph_nodes=sum(ops.values()), requests=stats["requests"], batches=stats["batches"],
        p50_ms=f"{stats['latency_ms_p50']:.2f}", p99_ms=f"{stats['latency_ms_p99']:.2f}",
        qa_per_s=f"{SERVE_REQUESTS / wall:.1f}", launches=fmt_launches(launches))
    del predict
    torch.cuda.empty_cache()
    return launches, path


def pageable_step_parts(batch, dev):
    """The engine's step before the pinned staging:
    the batch assembled into fresh numpy arrays, copied from pageable
    memory. Returns (host arrays, a function that copies them)."""
    b = SERVE_BATCH
    app = np.zeros((b,) + batch[0].appearance.shape, np.float32)
    mot = np.zeros((b,) + batch[0].motion.shape, np.float32)
    q = np.zeros((b, QLEN), np.int32)
    qlen = np.ones((b,), np.int32)
    for i, req in enumerate(batch):
        app[i], mot[i] = req.appearance, req.motion
        q[i, : req.question.shape[0]] = req.question
        qlen[i] = req.question.shape[0]
    return (app, mot, q, qlen), lambda host: tuple(torch.from_numpy(a).to(dev) for a in host)


def phase_serve_breakdown(model, reps=10):
    """One served batch of 32 at full width split into its four parts, with
    the step before the pinned staging (fresh numpy arrays, pageable copy)
    and this engine's (pinned staging reused, copies that do not block the
    host): host assembly, host-to-device copy (host clock to the copies'
    end), the forward with softmax and top-k (CUDA events), the fetch of
    the (32, 5) ids and scores (host clock); medians over ``reps`` steps
    after one warm-up, and the whole step (host clock)."""
    dev = next(model.parameters()).device
    batch = [Request(*r) for r in serve_requests()[:SERVE_BATCH]]
    program = ServingProgram(model, TOP_K).eval()
    eng = BatchingEngine(lambda *a: None, device=dev, max_batch=SERVE_BATCH, max_q_len=QLEN)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def pinned():
        host = eng._assemble(batch)
        return host, eng._to_device

    rows = {}
    try:
        for mode, assemble in (("pageable", lambda: pageable_step_parts(batch, dev)), ("pinned", pinned)):
            parts = {k: [] for k in ("assemble_ms", "h2d_ms", "forward_ms", "fetch_ms", "step_ms")}
            for rep in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                host, copy_fn = assemble()
                t1 = time.perf_counter()
                args = copy_fn(host)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                start.record()
                with torch.no_grad():
                    ids, scores = program(*args)
                end.record()
                end.synchronize()
                t3 = time.perf_counter()
                ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
                t4 = time.perf_counter()
                if rep:
                    for k, v in (("assemble_ms", t1 - t0), ("h2d_ms", t2 - t1), ("fetch_ms", t4 - t3),
                                 ("step_ms", t4 - t0)):
                        parts[k].append(v * 1e3)
                    parts["forward_ms"].append(start.elapsed_time(end))
            rows[mode] = {k: float(np.median(v)) for k, v in parts.items()}
            check(ids.shape == (SERVE_BATCH, TOP_K) and np.isfinite(scores).all(), f"breakdown {mode}: bad answers")
    finally:
        eng.close()
    nbytes = sum(a.nbytes for a in pageable_step_parts(batch, dev)[0])
    for mode, r in rows.items():
        say(f"serve breakdown {mode}", batch=SERVE_BATCH, batch_mb=f"{nbytes / 1e6:.1f}",
            **{k: f"{v:.3f}" for k, v in r.items()},
            h2d_gb_per_s=f"{nbytes / r['h2d_ms'] / 1e6:.2f}",
            shares=",".join(f"{k[:-3]}:{r[k] / r['step_ms']:.3f}" for k in ("assemble_ms", "h2d_ms", "forward_ms",
                                                                           "fetch_ms")))
    return rows


def cudnn_lstm(enc, x):
    """Bidirectional torch.nn.LSTM (cuDNN) with the weights of one of the
    model's BiLSTMs."""
    fwd, bwd = enc._params(""), enc._params("_reverse")
    lstm = torch.nn.LSTM(x.shape[-1], fwd.w_hh.shape[1], batch_first=True, bidirectional=True).to(x.device)
    with torch.no_grad():
        for sfx, p in (("", fwd), ("_reverse", bwd)):
            for k, v in zip(("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"), p):
                getattr(lstm, k + sfx).copy_(v)
    return lstm


def cudnn_train_ms(enc, x, lengths, with_outputs, gen):
    """cuDNN's training-mode forward and its backward on the same rows: the
    forward includes its input projection; the backward gives dX, dW_ih,
    dW_hh and the biases' gradients, from a cotangent on the final state
    (and on the outputs with ``with_outputs``)."""
    lstm = cudnn_lstm(enc, x)
    x = x.detach().requires_grad_()
    with torch.enable_grad():
        if lengths is None:
            inp = x
        else:
            inp = torch.nn.utils.rnn.pack_padded_sequence(
                x, lengths.cpu().long(), batch_first=True, enforce_sorted=False
            )
        fwd_ms = time_ms(lambda: lstm(inp), 5)
        out, (h_n, _) = lstm(inp)
        targets = [h_n] + ([out.data if lengths is not None else out] if with_outputs else [])
        cots = [torch.randn(t.shape, generator=gen, device=t.device) for t in targets]
        leaves = [x, *lstm.parameters()]
        bwd_ms = time_ms(lambda: torch.autograd.grad(targets, leaves, cots, retain_graph=True), 5)
    del out, h_n, targets
    return fwd_ms, bwd_ms


def train_lstm_case(name, enc, x, lengths, with_outputs, gen, gates=None):
    """Kernels 3 and 4 against their plain versions on the projections of
    one BiLSTM of the model, timed beside cuDNN's training forward and
    backward, with the bound of each from this case's shapes and lengths;
    with ``gates`` (bf16 xf, xb_rev) the bf16-gate variants, no yardstick."""
    fwd, bwd = enc._params(""), enc._params("_reverse")
    if gates is None:
        xf = time_major_input_proj(x, fwd)
        xb = time_major_input_proj(x, bwd, reverse=True)
    else:
        xf, xb = gates
    whf, whb = fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous()
    t_total, r, g = xf.shape
    h = g // 4
    fargs = (xf, xb, whf, whb, lengths)

    fwd_got = bilstm_train_fwd(*fargs, with_outputs=with_outputs)
    torch.cuda.synchronize()
    fwd_want = bilstm_train_fwd_reference(*fargs, with_outputs=with_outputs)
    fwd_err = 0.0
    for field, a, b in zip(("final", "outs", "hprev", "cprev", "acts"), fwd_got, fwd_want):
        if b is None:
            continue
        check(torch.isfinite(a).all().item(), f"train fwd {name} {field}: non-finite kernel output")
        fwd_err = max(fwd_err, max_err(a, b))
    check(fwd_err <= TOL_LSTM, f"train fwd {name}: kernel vs plain max abs err {fwd_err:.3e} > {TOL_LSTM}")

    # kernel 4 and the plain backward on the same inputs: kernel 3's
    # activations and c_{t-1} (the chain against the plain forward's is
    # tests/test_torch_kernels_cuda.py::test_train_kernels_match_plain)
    dfinal = torch.randn((r, 2 * h), generator=gen, device=xf.device)
    douts = torch.randn((r, t_total, 2 * h), generator=gen, device=xf.device) if with_outputs else None
    bargs = (fwd_got[4], whf, whb, lengths, fwd_got[3], dfinal, douts)
    got = bilstm_train_bwd(*bargs)
    torch.cuda.synchronize()
    want = bilstm_train_bwd_reference(*bargs)
    del fwd_got, fwd_want
    bwd_err, bwd_tol = 0.0, 0.0
    for field, a, b in zip(("dxf", "dxb"), got, want):
        check(torch.isfinite(a).all().item(), f"train bwd {name} {field}: non-finite kernel output")
        err, tol = max_err(a, b), TOL_LSTM_BWD * max(1.0, b.abs().max().item())
        check(err <= tol, f"train bwd {name} {field}: kernel vs plain max abs err {err:.3e} > {tol:.3e}")
        bwd_err, bwd_tol = max(bwd_err, err), max(bwd_tol, tol)
    del got, want

    fwd_ms = time_ms(lambda: bilstm_train_fwd(*fargs, with_outputs=with_outputs), 10)
    plan = cluster_plan("bilstm_train_fwd", xf)
    if name.startswith("appearance"):
        say(f"bilstm_train {name} under load",
            **under_load(lambda: bilstm_train_fwd(*fargs, with_outputs=with_outputs)))
    fwd_plain_ms = time_ms(lambda: bilstm_train_fwd_reference(*fargs, with_outputs=with_outputs), 3)
    bwd_ms = time_ms(lambda: bilstm_train_bwd(*bargs), 10)
    bwd_plan = cluster_plan("bilstm_train_bwd", xf)
    bwd_plain_ms = time_ms(lambda: bilstm_train_bwd_reference(*bargs), 3)
    lib_fwd_ms, lib_bwd_ms = cudnn_train_ms(enc, x, lengths, with_outputs, gen) if gates is None else (None, None)

    # what these inputs need: each direction runs len_r steps of row r; a
    # step of the forward is one (H) @ (H, 4H) product, of the backward one
    # too (dgates @ W_hh^T: the gates are the forward's activations). Inputs
    # are counted at the valid steps, outputs in full.
    steps = t_total * r if lengths is None else int(lengths.sum().item())
    gb = xf.element_size()  # bytes per gate read
    len_bytes = 4 * r if lengths is not None else 0
    # hprev and cprev, (T, R, 2H) each, and the activations, (2, T, R, 4H)
    res_bytes = 4 * (2 * t_total * r * 2 * h + 2 * t_total * r * g)
    f_flops = 2 * steps * 2 * h * g
    f_bytes = gb * 2 * steps * g + 4 * (2 * h * g + r * 2 * h) + len_bytes + res_bytes
    if with_outputs:
        f_bytes += 4 * r * t_total * 2 * h
    b_flops = f_flops
    # the fp32 activations and c_{t-1} read, W_hh, dfinal, the dgates written
    b_bytes = 4 * (2 * steps * g + 2 * steps * h + 2 * h * g + r * 2 * h + 2 * t_total * r * g) + len_bytes
    if with_outputs:
        b_bytes += 4 * r * t_total * 2 * h
    f_bound, f_by = bound_ms(f_flops, f_bytes)
    b_bound, b_by = bound_ms(b_flops, b_bytes)
    say(f"bilstm_train {name}", T=t_total, R=r, H=h, gates="bf16" if gates is not None else "fp32",
        masked=lengths is not None, outputs=with_outputs,
        fwd_err=f"{fwd_err:.3e}", fwd_tol=TOL_LSTM, bwd_err=f"{bwd_err:.3e}", bwd_tol=f"{bwd_tol:.3e}",
        fwd_ms=f"{fwd_ms:.4f}", fwd_per_block_recorded_ms=PER_BLOCK_RECORDED_MS["bilstm_train_fwd"][name],
        fwd_plan=fmt_plan(plan),
        fwd_plain_ms=f"{fwd_plain_ms:.4f}", fwd_cudnn_ms=lib_fwd_ms,
        fwd_bound_ms=f"{f_bound:.4f}", fwd_bound_by=f_by,
        bwd_ms=f"{bwd_ms:.4f}", bwd_per_block_recorded_ms=PER_BLOCK_RECORDED_MS["bilstm_train_bwd"][name],
        bwd_plan=fmt_plan(bwd_plan), bwd_ptxas=repr(ptxas_summary("bilstm_train_bwd.cu")),
        bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_cudnn_ms=lib_bwd_ms,
        bwd_bound_ms=f"{b_bound:.4f}", bwd_bound_by=b_by)
    return (
        dict(shape=name, err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=lib_fwd_ms,
             bound_ms=f_bound, flops=f_flops, bytes=f_bytes, plan=plan),
        dict(shape=name, err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
             bound_ms=b_bound, flops=b_flops, bytes=b_bytes, plan=bwd_plan),
    )


@torch.no_grad()
def phase_bilstm_train(model, app, q, qlen):
    """Kernels 3 and 4 at the three shapes of one flagship train step: the
    appearance encoder (final only, unmasked), concatRNN (masked, outputs)
    and the question encoder (masked, final only)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    words = torch.tanh(model.linguistic_input_unit.encoder_embed(q))
    b, c, f, d = app.shape
    clips = torch.tanh(app).reshape(b * c, f, d)
    cases = [
        train_lstm_case("appearance", model.visual_appearance_input_unit.encoder, clips, None, False, gen),
        train_lstm_case("question_outputs", model.linguistic_input_unit.concatRNN.rnn, words, qlen, True,
                        gen),
        train_lstm_case("question_final", model.linguistic_input_unit.encoder, words, qlen, False, gen),
    ]
    del clips
    torch.cuda.empty_cache()
    return [c[0] for c in cases], [c[1] for c in cases]


def module_grad_norms(model):
    """The gradient norm of each top-level module of the model."""
    return {name: torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in mod.parameters()])).item()
            for name, mod in model.named_children()}


def phase_train(batch, compute_dtype="float32", graph_module="GAT"):
    """The flagship train step in ``compute_dtype``: warm-up steps, then the
    agreement (fp32: kernel path against plain path; bf16: the bf16 kernel
    path against the fp32 kernel path, from the same weights), then timed
    steps on the kernel path (the training path whose launches count) and
    one step under the profiler.

    The agreement is checked after the warm-up: at the seeded init every
    bias is zero, so QueryAttn l2-normalizes exactly-zero vectors at the
    padded question positions and its bias gradient is rounding noise times
    1e12, in any implementation; two updates move the biases off zero.
    """
    bf16 = compute_dtype == "bfloat16"
    tag = ("gcn " if graph_module == "GCN" else "") + ("train bf16" if bf16 else "train")
    tol_loss, tol_gnorm = (TOL_BF16_TRAIN_LOSS, TOL_BF16_TRAIN_GNORM) if bf16 else (TOL_TRAIN_LOSS, TOL_TRAIN_GNORM)
    lr = cfg_from_file(TRAIN_CFG).train.lr
    model = build_model(seed=0, compute_dtype=compute_dtype, graph_module=graph_module, **FLAGSHIP)
    state = create_train_state(model, make_optimizer(lr, steps_per_epoch=100), seed=0)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    rates = [m.p for m in drops]
    for _ in range(WARMUP_STEPS):
        train_step(state, batch, alpha=ALPHA, beta=BETA)

    # agreement: one step's loss and gradients from the same weights,
    # dropout off, this path then the one it is held against
    for m in drops:
        m.p = 0.0
    reset_counts()
    metrics = forward_backward(state, batch, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == TRAIN_LAUNCHES[compute_dtype],
          f"one {tag} step launched {launches} kernels, want {TRAIN_LAUNCHES[compute_dtype]}")
    loss_k, gn_k = metrics["loss"].item(), module_grad_norms(model)
    if bf16:
        model.compute_dtype = "float32"
    else:
        model.use_kernels = False
    metrics = forward_backward(state, batch, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    other = launch_counts()
    loss_p, gn_p = metrics["loss"].item(), module_grad_norms(model)
    model.use_kernels, model.compute_dtype = True, compute_dtype
    want_other = tuple(a + b for a, b in zip(launches, TRAIN_LAUNCHES["float32"] if bf16
                                             else (0,) * len(COUNTED_KERNELS)))
    check(other == want_other, f"the reference path launched {other} kernels after {launches}, want {want_other}")
    check(np.isfinite(loss_k) and np.isfinite(loss_p), f"non-finite loss {loss_k} / {loss_p}")
    rel_loss = abs(loss_k - loss_p) / max(abs(loss_p), 1e-9)
    rel_gn = {k: abs(gn_k[k] - gn_p[k]) / max(gn_p[k], 1e-12) for k in gn_p}
    against = "fp32 kernel path" if bf16 else "plain path"
    check(rel_loss <= tol_loss, f"{tag} loss {loss_k} vs {against} {loss_p}: rel {rel_loss:.2e}")
    bad = {k: f"{v:.2e}" for k, v in rel_gn.items() if not v <= tol_gnorm}
    check(not bad, f"{tag}: per-module gradient norms off the {against} by more than {tol_gnorm}: {bad}")
    worst = max(rel_gn, key=rel_gn.get)
    say(f"{tag} agreement", after_steps=WARMUP_STEPS, against=against.replace(" ", "_"),
        loss_kernel=f"{loss_k:.6f}", loss_against=f"{loss_p:.6f}", rel_loss=f"{rel_loss:.2e}",
        tol_loss=tol_loss, worst_module=worst, worst_gnorm_rel=f"{rel_gn[worst]:.2e}", tol_gnorm=tol_gnorm,
        gnorm_rel=",".join(f"{k}:{v:.1e}" for k, v in sorted(rel_gn.items())))
    model.zero_grad(set_to_none=True)

    # timed steps, dropout on
    for m, p in zip(drops, rates):
        m.p = p
    train_step(state, batch, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    losses = [train_step(state, batch, alpha=ALPHA, beta=BETA)["loss"] for _ in range(TIMED_STEPS)]
    end.record()
    end.synchronize()
    launches = launch_counts()
    ms = start.elapsed_time(end) / TIMED_STEPS
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)), f"non-finite train losses {losses}")
    want = tuple(n * TIMED_STEPS for n in TRAIN_LAUNCHES[compute_dtype])
    check(launches == want, f"{TIMED_STEPS} {tag} steps launched {launches} kernels, want {want}")
    say(tag, batch=BATCH, valid=BATCH - TRAIN_PAD, lr=lr, step_ms=f"{ms:.3f}",
        qa_per_s=f"{BATCH / ms * 1e3:.1f}", losses=",".join(f"{v:.5f}" for v in losses),
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=f"bilstm_train_fwd:{launches[2]},bilstm_train_bwd:{launches[3]},"
                 f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]},input_proj_both:{launches[5]},"
                 f"input_proj_f32:{launches[7]},input_proj_f32_wgrad:{launches[8]},whh_grad_f32:{launches[9]}")
    profile_run(f"{tag} profile", lambda: train_step(state, batch, alpha=ALPHA, beta=BETA))
    return launches, ms


def tanh_case(x):
    """The tanh pass on the probe's x: bit for bit against its plain version,
    timed beside it and beside one ``torch.tanh(x, out=bf16)`` call, bound
    by its bytes (x read in fp32, the result written in bf16)."""
    got, want = tanh_to_bf16(x), tanh_to_bf16_reference(x)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int16), want.view(torch.int16)), "tanh_to_bf16: not bit-exact")
    lib_out = torch.empty_like(got)
    torch.tanh(x, out=lib_out)
    check(torch.equal(lib_out.view(torch.int16), want.view(torch.int16)), "torch.tanh(out=bf16) differs")
    del got, want
    ms, plain_ms = time_ms(lambda: tanh_to_bf16(x), 20), time_ms(lambda: tanh_to_bf16_reference(x), 5)
    library_ms = time_ms(lambda: torch.tanh(x, out=lib_out), 20)
    nbytes = x.numel() * (4 + 2)
    bms, by = bound_ms(0, nbytes)
    say("proj tanh_to_bf16", R=x.shape[0], T=x.shape[1], D=x.shape[2], bit_exact=True, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
        tb_per_s=f"{nbytes / ms / 1e9:.3f}", share_of_bound=f"{bms / ms:.3f}")
    return dict(err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by)


def proj_case(rows, gen):
    """Kernels 5 and 6 against their plain versions on one set of the
    probe's inputs at ``rows`` = R, timed beside the probe's library
    yardsticks v0 (two products) and v1 (one merged product), with the bound
    at the bf16 tensor-core peak, the achieved TFLOP/s and the share of the
    bound; the tanh pass on the same x first. Returns the rows of kernels 5
    and 6 and the tanh pass's."""
    x, w_f, b_f, w_b, b_b = proj_probe.make_inputs(rows, gen)
    tanh = tanh_case(x)
    x16 = torch.tanh(x).to(BF16)
    forms = {
        "k5_forward": (lambda: input_proj_one(x, w_f, b_f), lambda: input_proj_one_reference(x, w_f, b_f)),
        "k5_reversed": (lambda: input_proj_one(x, w_b, b_b, reverse=True),
                        lambda: input_proj_one_reference(x, w_b, b_b, reverse=True)),
        "k6_tanh": (lambda: input_proj_both(x, w_f, b_f, w_b, b_b),
                    lambda: input_proj_both_reference(x, w_f, b_f, w_b, b_b)),
        "k6_bf16_x": (lambda: input_proj_both(x16, w_f, b_f, w_b, b_b, fuse_tanh=False),
                      lambda: input_proj_both_reference(x16, w_f, b_f, w_b, b_b, fuse_tanh=False)),
    }
    r, t, d = x.shape
    g = w_f.shape[0]
    res = {}
    for name, (kernel, plain) in forms.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        errs = [check_bf16(f"proj {name} R={rows}", a, b, TOL_BF16_PROJ_ATOL) for a, b in zip(got, want)]
        del got, want
        share = max(e[2] for e in errs)
        check(share <= TOL_BF16_PROJ_SHARE, f"proj {name} R={rows}: {share:.2e} of the elements differ")
        ms, plain_ms = time_ms(kernel, 20), time_ms(plain, 3)
        ndir = 1 if name.startswith("k5") else 2
        flops = 2 * r * t * d * g * ndir
        x_bytes = x16.numel() * 2 if name == "k6_bf16_x" else x.numel() * 4
        nbytes = x_bytes + ndir * (g * d * 2 + g * 4 + t * r * g * 2)  # x, W in bf16, bias, out
        bms, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
        res[name] = dict(err=max(e[0] for e in errs), steps=max(e[1] for e in errs), share=share, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, by=by, flops=flops, bytes=nbytes)
    lib = proj_probe.variants(x, w_f, b_f, w_b, b_b)
    v0_ms, v1_ms = time_ms(lib["v0_library"], 10), time_ms(lib["v1_merged"], 10)
    # context for what bounds the product: cuBLAS's bf16 GEMM of the same
    # operands, bf16 out (no fp32 bias before the rounding, no time-major
    # layout: not the function, so no yardstick of any row)
    a16, w16 = x16.view(r * t, d), torch.cat([w_f, w_b]).to(BF16)
    gemm_ms = time_ms(lambda: a16 @ w16.t(), 20)
    say("proj cublas_bf16_gemm", R=rows, M=r * t, N=2 * g, K=d, ms=f"{gemm_ms:.4f}",
        tflops=f"{res['k6_bf16_x']['flops'] / gemm_ms / 1e9:.1f}")
    del a16, w16
    for name, c in res.items():
        say(f"proj {name}", R=rows, T=t, D=d, G=g, max_abs_err=f"{c['err']:.3e}",
            max_bf16_steps=f"{c['steps']:.2f}", share_differ=f"{c['share']:.2e}",
            tol=f"1 bf16 step + {TOL_BF16_PROJ_ATOL} on <= {TOL_BF16_PROJ_SHARE} of them", ms=f"{c['ms']:.4f}",
            plain_ms=f"{c['plain_ms']:.4f}",
            library_v0_ms=f"{v0_ms:.4f}", library_v1_ms=f"{v1_ms:.4f}", bound_ms=f"{c['bound_ms']:.4f}",
            bound_by=c["by"], tflops=f"{c['flops'] / c['ms'] / 1e9:.1f}",
            share_of_bound=f"{c['bound_ms'] / c['ms']:.3f}")
    # kernel 5's row: its two launches of the probe's v2 (forward, reversed);
    # kernel 6's: the form on fp32 x of the bf16 forward, bf16 x beside it
    k5 = dict(shape=f"R{rows}", err=max(res["k5_forward"]["err"], res["k5_reversed"]["err"]),
              **{k: res["k5_forward"][k] + res["k5_reversed"][k] for k in ("ms", "plain_ms", "flops", "bytes")},
              library_ms=v0_ms)
    k6 = dict(shape=f"R{rows}", err=max(res["k6_tanh"]["err"], res["k6_bf16_x"]["err"]),
              **{k: res["k6_tanh"][k] for k in ("ms", "plain_ms", "flops", "bytes")}, library_ms=v0_ms,
              library_v1_ms=v1_ms, bf16_x_ms=res["k6_bf16_x"]["ms"], bf16_x_bound_ms=res["k6_bf16_x"]["bound_ms"])
    for c in (k5, k6):
        c["bound_ms"] = bound_ms(c["flops"], c["bytes"], PEAK_BF16_FLOPS)[0]
    return k5, k6, dict(shape=f"R{rows}", **tanh)


@torch.no_grad()
def phase_proj():
    """Kernels 5 and 6 at the projection's two R, then the port's probe
    (v0-v4, one line) and one call of its v2, whose launches of kernel 5
    are counted: the probe is kernel 5's path."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [proj_case(rows, gen) for rows in PROJ_ROWS]
    torch.cuda.empty_cache()
    probe = proj_probe.run(PROJ_ROWS[0], iters=20)
    print("[proj_probe] " + json.dumps(probe), flush=True)
    v2 = proj_probe.variants(*proj_probe.make_inputs(PROJ_ROWS[0], gen))["v2_kernel5"]
    reset_counts()
    v2()
    torch.cuda.synchronize()
    n5, n_tanh = launch_counts()[4], launch_counts()[6]
    check((n5, n_tanh) == (2, 2), f"the probe's v2 launched kernel 5 {n5} and the tanh pass {n_tanh} times, want 2")
    torch.cuda.empty_cache()
    return [c[0] for c in cases], [c[1] for c in cases], [c[2] for c in cases], n5


@torch.no_grad()
def phase_proj_f32():
    """Kernel 7 at the train cells' shapes (R*T = R x 16 rows, D 2,048, 2 x
    1,536 columns): its relative error against the fp64 product beside
    ``torch.baddbmm``'s in fp32 and in TF32 (at most twice the fp32 one;
    TF32's beyond that), ms, the plain version's ms (the two baddbmm
    products, the bias broadcast and the flip), the library yardstick (one
    ``torch.baddbmm`` over both directions' columns, no flip), the bound (the
    three products at the TF32 tensor-core peak, or the bytes: x, W_hi and
    W_lo, the bias, the output), TFLOP/s of the product and the share of the
    bound, one launch a call. Returns the cases, msrvtt-qa's first."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for cell, rows in PROJ_F32_ROWS.items():
        args = f32_inputs(rows, gen)
        x, w_f, b_f, w_b, b_b = args
        want = fp64_product(*args)
        e_fp32, e_tf32 = baddbmm_errors(args, want)
        reset_counts()
        got = input_proj_f32(*args)
        torch.cuda.synchronize()
        check(launch_counts()[7] == 1, f"kernel 7 launched {launch_counts()[7]} times for one call")
        err = rel_error(got, want)
        abs_err = max((a.double() - b).abs().max().item() for a, b in zip(got, want))
        check(err <= 2 * e_fp32, f"kernel 7 at {cell}: error {err:.3e} against baddbmm's fp32 {e_fp32:.3e}")
        check(e_tf32 > 2 * e_fp32, f"baddbmm in TF32 at {cell}: {e_tf32:.3e} within 2x fp32's {e_fp32:.3e}")
        del got, want
        r, t, d = x.shape
        g = w_f.shape[0]
        w_cat, b_cat = torch.cat([w_f, w_b]).t(), torch.cat([b_f, b_b])
        ms, plain_ms = time_ms(lambda: input_proj_f32(*args), 10), time_ms(lambda: input_proj_f32_reference(*args), 3)
        library_ms = time_ms(lambda: torch.baddbmm(b_cat, x.transpose(0, 1), w_cat.expand(t, *w_cat.shape)), 3)
        product = 2 * r * t * d * 2 * g
        nbytes = x.numel() * 4 + 2 * (2 * g * d * 4) + 2 * g * 4 + 2 * t * r * g * 4  # x, W_hi, W_lo, bias, out
        bms, by = bound_ms(3 * product, nbytes, PEAK_TF32_FLOPS)
        mhz, watts, limit = clocks_under_load(lambda: input_proj_f32(*args))
        say(f"proj_f32 {cell}", R=r, T=t, D=d, G=g, rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}",
            baddbmm_fp32_rel_err=f"{e_fp32:.3e}", baddbmm_tf32_rel_err=f"{e_tf32:.3e}",
            err_over_fp32=f"{err / e_fp32:.2f}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by,
            product_tflops=f"{product / ms / 1e9:.1f}", tensor_core_tflops=f"{3 * product / ms / 1e9:.1f}",
            share_of_bound=f"{bms / ms:.3f}", sm_mhz=f"{mhz:.0f}", power_w=f"{watts:.1f}", power_limit_w=limit,
            launches=1)
        cases.append(dict(shape=f"{cell}_R{r}", err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bms, flops=3 * product, bytes=nbytes))
        del args, x, w_f, b_f, w_b, b_b, w_cat, b_cat
        torch.cuda.empty_cache()
    return cases


@torch.no_grad()
def phase_wgrad_f32():
    """Kernel 8 at the train cells' shapes (R*T = R x 16 rows, D 2,048, 2 x
    1,536 gate rows): its relative error against the fp64 product beside
    the library SGEMMs' in fp32 and in TF32 (at most twice the fp32 one;
    TF32's beyond that), ms, the plain version's ms (the two SGEMMs after
    their transposing copies, the library yardstick too), the bound (the
    three products at the TF32 tensor-core peak, or the bytes: x and the
    dgates once, dW), TFLOP/s of the product and the share of the bound,
    one launch a call. Returns the cases, msrvtt-qa's first."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = []
    for cell, rows in PROJ_F32_ROWS.items():
        args = wgrad_inputs(rows, gen)
        x, dxf, _ = args
        want = fp64_wgrad(*args)
        e_fp32, e_tf32 = sgemm_errors(args, want)
        reset_counts()
        got = input_proj_f32_wgrad(*args)
        torch.cuda.synchronize()
        check(launch_counts()[8] == 1, f"kernel 8 launched {launch_counts()[8]} times for one call")
        err = rel_error(got, want)
        abs_err = max((a.double() - b).abs().max().item() for a, b in zip(got, want))
        check(err <= 2 * e_fp32, f"kernel 8 at {cell}: error {err:.3e} against the SGEMMs' fp32 {e_fp32:.3e}")
        check(e_tf32 > 2 * e_fp32, f"the SGEMMs in TF32 at {cell}: {e_tf32:.3e} within 2x fp32's {e_fp32:.3e}")
        del got, want
        r, t, d = x.shape
        g = dxf.shape[-1]
        ms = time_ms(lambda: input_proj_f32_wgrad(*args), 10)
        plain_ms = time_ms(lambda: input_proj_f32_wgrad_reference(*args), 3)
        product = 2 * r * t * d * 2 * g
        nbytes = x.numel() * 4 + 2 * dxf.numel() * 4 + 2 * g * d * 4  # x, the dgates, dW
        bms, by = bound_ms(3 * product, nbytes, PEAK_TF32_FLOPS)
        mhz, watts, limit = clocks_under_load(lambda: input_proj_f32_wgrad(*args))
        say(f"wgrad_f32 {cell}", R=r, T=t, D=d, G=g, rel_err=f"{err:.3e}", max_abs_err=f"{abs_err:.3e}",
            sgemm_fp32_rel_err=f"{e_fp32:.3e}", sgemm_tf32_rel_err=f"{e_tf32:.3e}",
            err_over_fp32=f"{err / e_fp32:.2f}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bms:.4f}", bound_by=by, product_tflops=f"{product / ms / 1e9:.1f}",
            tensor_core_tflops=f"{3 * product / ms / 1e9:.1f}", share_of_bound=f"{bms / ms:.3f}",
            sm_mhz=f"{mhz:.0f}", power_w=f"{watts:.1f}", power_limit_w=limit, launches=1)
        cases.append(dict(shape=f"{cell}_R{r}", err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=plain_ms, bound_ms=bms, flops=3 * product, bytes=nbytes))
        del args, x, dxf
        torch.cuda.empty_cache()
    return cases


@torch.no_grad()
def phase_whh_grad_f32():
    """Kernel 9 at the train cells' appearance BiLSTM shapes (R*T = R x 16
    rows, H 384, 2 x 1,536 gate rows) and at a question BiLSTM's (256 x
    24): its relative error against the fp64 product beside the library
    SGEMMs' in fp32 and in TF32 (at most the fp32 one at the cells' shapes;
    TF32's beyond twice it), ms, the plain version's ms (the two SGEMMs it
    replaces, the library yardstick too), the splits of K, the bound (the
    three products at the TF32 tensor-core peak, or the bytes: hprev and
    the dgates once, dW), TFLOP/s of the product and the share of the
    bound, one launch a call. Returns the cases, msrvtt-qa's first."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = []
    for shape, (rows, steps) in WHH_SHAPES.items():
        args = whh_inputs(rows, gen, t=steps)
        hprev, dxf, _ = args
        want = fp64_whh(*args)
        e_fp32, e_tf32 = whh_sgemm_errors(args, want)
        reset_counts()
        got = whh_grad_f32(*args)
        torch.cuda.synchronize()
        check(launch_counts()[9] == 1, f"kernel 9 launched {launch_counts()[9]} times for one call")
        err = rel_error(got, want)
        abs_err = max((a.double() - b).abs().max().item() for a, b in zip(got, want))
        bound = e_fp32 if shape in PROJ_F32_ROWS else max(e_fp32, 1e-6)
        check(err <= bound, f"kernel 9 at {shape}: error {err:.3e} against the SGEMMs' fp32 {e_fp32:.3e}")
        check(e_tf32 > 2 * e_fp32, f"the SGEMMs in TF32 at {shape}: {e_tf32:.3e} within 2x fp32's {e_fp32:.3e}")
        del got, want
        t, r, c = hprev.shape
        h, g = c // 2, dxf.shape[-1]
        ms = time_ms(lambda: whh_grad_f32(*args), 10)
        plain_ms = time_ms(lambda: whh_grad_f32_reference(*args), 3)
        product = 2 * r * t * h * 2 * g
        nbytes = hprev.numel() * 4 + 2 * dxf.numel() * 4 + 2 * h * g * 4  # hprev, the dgates, dW
        bms, by = bound_ms(3 * product, nbytes, PEAK_TF32_FLOPS)
        mhz, watts, limit = clocks_under_load(lambda: whh_grad_f32(*args))
        say(f"whh_grad_f32 {shape}", R=r, T=t, H=h, G=g,
            splits=whh_grad_plan(r, t, h, whh_grad_kernel.sm_count(hprev.device)), rel_err=f"{err:.3e}",
            max_abs_err=f"{abs_err:.3e}", sgemm_fp32_rel_err=f"{e_fp32:.3e}", sgemm_tf32_rel_err=f"{e_tf32:.3e}",
            err_over_fp32=f"{err / e_fp32:.2f}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{bms:.4f}", bound_by=by, product_tflops=f"{product / ms / 1e9:.1f}",
            tensor_core_tflops=f"{3 * product / ms / 1e9:.1f}", share_of_bound=f"{bms / ms:.3f}",
            sm_mhz=f"{mhz:.0f}", power_w=f"{watts:.1f}", power_limit_w=limit, launches=1)
        cases.append(dict(shape=f"{shape}_R{r}_T{t}", err=abs_err, rel_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=plain_ms, bound_ms=bms, flops=3 * product, bytes=nbytes))
        del args, hprev, dxf
        torch.cuda.empty_cache()
    return cases


@torch.no_grad()
def phase_bilstm_bf16(model, app, q, qlen, gen):
    """The bf16-gate variants at the shapes of the bf16 paths: kernel 1 at
    the three BiLSTMs of the bf16 forward (the appearance gates from kernel
    6 with tanh fused, the question gates streamed and rounded, as
    ``ops/lstm.py`` makes them), kernels 3 and 4 at the appearance shape of
    the bf16 train step (gates from kernel 6 without tanh)."""
    qe, ae = model.linguistic_input_unit, model.visual_appearance_input_unit.encoder
    words = torch.tanh(qe.encoder_embed(q))
    b, c, f, d = app.shape
    clips = app.reshape(b * c, f, d)
    fwd, bwd = ae._params(""), ae._params("_reverse")
    bias = lambda p: p.b_ih + p.b_hh
    app_gates = input_proj_both(clips, fwd.w_ih, bias(fwd), bwd.w_ih, bias(bwd))

    def question_gates(enc):
        fw, bw = enc._params(""), enc._params("_reverse")
        return (time_major_input_proj(words, fw, stream_dtype=BF16).to(BF16),
                time_major_input_proj(words, bw, reverse=True, stream_dtype=BF16).to(BF16))

    eval_cases = [
        lstm_case("appearance_bf16", ae, None, None, False, gates=app_gates),
        lstm_case("question_outputs_bf16", qe.concatRNN.rnn, None, qlen, True,
                  gates=question_gates(qe.concatRNN.rnn)),
        lstm_case("question_final_bf16", qe.encoder, None, qlen, False, gates=question_gates(qe.encoder)),
    ]
    del app_gates
    x16 = torch.tanh(clips).to(BF16)
    train_gates = input_proj_both(x16, fwd.w_ih, bias(fwd), bwd.w_ih, bias(bwd), fuse_tanh=False)
    del x16
    fwd_case, bwd_case = train_lstm_case("appearance_bf16", ae, None, None, False, gen, gates=train_gates)
    del train_gates
    torch.cuda.empty_cache()
    return eval_cases, fwd_case, bwd_case


@torch.no_grad()
def phase_eval_bf16(model, app, mot, q, qlen, fp32_logits, tag="eval bf16", want=EVAL_LAUNCHES["bfloat16"]):
    """The flagship forward in bf16, kernel routing, against the fp32 kernel
    path's logits (``fp32_logits``, from the same weights and inputs);
    ``want`` the launches of one forward. Returns (ms, launches)."""
    model.use_kernels, model.compute_dtype = True, "bfloat16"
    reset_counts()
    out = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == want, f"one {tag} forward launched {launches} kernels, want {want}")
    logits = out.logits
    check(logits.dtype == torch.float32 and tuple(logits.shape) == (BATCH, FLAGSHIP["num_answers"]),
          f"bf16 logits {logits.dtype} {tuple(logits.shape)}")
    for field in out._fields:
        check(torch.isfinite(getattr(out, field)).all().item(), f"bf16: non-finite {field}")
    scale = fp32_logits.abs().max().item()
    err = max_err(logits, fp32_logits)
    flips = logits.argmax(-1) != fp32_logits.argmax(-1)
    top2 = fp32_logits.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    unexplained = int((flips & (margin > 2 * err)).sum().item())
    agree = 1.0 - flips.float().mean().item()
    check(err <= TOL_BF16_LOGITS * scale, f"bf16 logits max abs err {err:.3e} > {TOL_BF16_LOGITS} * {scale:.3e}")
    check(unexplained == 0, f"{unexplained} argmax flips on rows whose fp32 top-2 margin exceeds 2 x {err:.3e}")
    ms = time_ms(lambda: model(app, mot, q, qlen), 5)
    say(tag, batch=BATCH, logits_max_abs_err=f"{err:.3e}", rel_to_max_logit=f"{err / scale:.3e}",
        tol=f"{TOL_BF16_LOGITS}*max|logit|", max_abs_logit=f"{scale:.3e}", argmax_agreement=f"{agree:.4f}",
        flips=int(flips.sum().item()),
        launches_per_forward=f"input_proj_both:{launches[5]},tanh_to_bf16:{launches[6]},"
                             f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]}",
        forward_ms=f"{ms:.3f}", qa_per_s=f"{BATCH / ms * 1e3:.1f}")
    profile_run(f"{tag} profile", lambda: model(app, mot, q, qlen))
    return ms, launches


def train_batch(gen):
    """The flagship inputs plus answers from a seeded generator and a valid
    mask with the last TRAIN_PAD rows padded."""
    app, mot, q, qlen = flagship_inputs(BATCH, gen)
    answers = torch.randint(0, FLAGSHIP["num_answers"], (BATCH,), generator=gen, device=gen.device)
    valid = torch.ones(BATCH, device=gen.device)
    valid[-TRAIN_PAD:] = 0.0
    return app, mot, q, qlen, answers, valid


# --- phases cli and cli bf16: the CLIs on a dataset held in memory ---
# MSRVTT-QA's shape at the flagship width (configs/msrvtt_qa_DualVGR_16.yml):
# 384 videos (805 MB of fp32 appearance, 50 MB of motion) in FeatureStores
# built in memory; 640 training questions (two full batches and a padded
# final batch of 128), 256 for validation, 300 for the test (a full batch
# and a padded one of 44); answers drawn at random from five answer words,
# so that within six steps the model moves toward them (a best-on-val
# checkpoint exists) while each row's prediction among them still follows
# its features
CLI_VIDEOS, CLI_SPLITS, CLI_EPOCHS = 384, {"train": 640, "val": 256, "test": 300}, 2
CLI_LR = 1e-3
CLI_ANSWER_IDS = (3, 10, 17, 24, 31)
BUCKET_WORDS = ("what", "who", "how", "when", "where")
# the tpu.metrics_jsonl fields of the JAX train.py (its train.py:281-305, :324-331)
CLI_TRAIN_KEYS = {"type", "wall_s", "epoch", "step", "ce", "avg_loss", "batch_acc", "avg_acc", "lr"}
CLI_VAL_KEYS = {"type", "wall_s", "epoch", "acc", "categories", "best"}


def cli_dataset(root):
    """The phase's dataset under ``root``: vocab, question pickles and the
    YAML config (save_dir and the profiler's directory under ``root``);
    the features as (appearance, motion) pairs of in-memory FeatureStores
    by store dtype: float32, and bfloat16 cast once from the same arrays
    (as a bf16 run caches an HDF5 file). Everything from fixed seeds."""
    vd, name = FLAGSHIP["vision_dim"], "msrvtt-qa"
    gen = torch.Generator(device="cuda").manual_seed(7)
    app = torch.randn((CLI_VIDEOS, CLIPS, FRAMES, vd), generator=gen, device="cuda").cpu()
    mot = torch.randn((CLI_VIDEOS, CLIPS, vd), generator=gen, device="cuda").cpu()
    video_ids = np.arange(1000, 1000 + CLI_VIDEOS)
    stores = {dt: (FeatureStore.from_array(video_ids, app, "resnet_features", store_dtype=dt),
                   FeatureStore.from_array(video_ids, mot, "resnext_features", store_dtype=dt))
              for dt in ("float32", "bfloat16")}
    words = {"<NULL>": 0, "<UNK>": 1, **{w: 2 + i for i, w in enumerate(BUCKET_WORDS)}}
    words.update({f"word{i}": i for i in range(len(words), FLAGSHIP["question_vocab_size"])})
    answers = {f"ans{i}": i for i in range(FLAGSHIP["num_answers"])}
    with open(os.path.join(root, f"{name}_vocab.json"), "w") as f:
        json.dump({"question_token_to_idx": words, "answer_token_to_idx": answers,
                   "question_answer_token_to_idx": {"<NULL>": 0, "<UNK>": 1}}, f)
    rng = np.random.RandomState(7)
    qid = 0
    for split, n in CLI_SPLITS.items():
        qlen = rng.randint(4, QLEN + 1, n).astype(np.int32)
        q = rng.randint(2 + len(BUCKET_WORDS), FLAGSHIP["question_vocab_size"], (n, QLEN)).astype(np.int32)
        q[:, 0] = 2 + np.arange(n) % len(BUCKET_WORDS)
        q[np.arange(QLEN)[None, :] >= qlen[:, None]] = 0
        vids = rng.choice(video_ids, n)
        obj = {"questions": q, "questions_len": qlen, "question_id": list(range(qid, qid + n)),
               "video_ids": vids, "video_names": [f"video{v}" for v in vids],
               "answers": rng.choice(CLI_ANSWER_IDS, n).tolist(),
               "glove": (rng.randn(len(words), FLAGSHIP["word_dim"]) * 0.1).astype(np.float32)
               if split == "train" else None}
        qid += n
        with open(os.path.join(root, f"{name}_{split}_questions.pt"), "wb") as f:
            pickle.dump(obj, f)
    cfg_path = os.path.join(root, "cli_smoke.yml")
    with open(cfg_path, "w") as f:
        f.write(f"""seed: 666
exp_name: 'cliSmoke'
model_type: 'DualVGR'
graph_module: 'GAT'
graph_layers: 1
train:
  lr: {CLI_LR}
  batch_size: {BATCH}
  max_epochs: {CLI_EPOCHS}
  vision_dim: {vd}
  word_dim: {FLAGSHIP["word_dim"]}
  module_dim: {FLAGSHIP["module_dim"]}
  glove: True
  num_of_nodes: {FLAGSHIP["num_of_nodes"]}
val:
  flag: True
test:
  write_preds: True
dataset:
  name: '{name}'
  data_dir: '{root}'
  save_dir: '{root}/results/'
tpu:
  metrics_jsonl: 'metrics.jsonl'
  profile_dir: '{root}/profile'
""")
    return cfg_path, stores


def cli_run_validate(cfg, stores, **tpu):
    """``validate.run`` on the best checkpoint with ``tpu`` keys set; its
    printed lines kept out of this script's output. Returns (accuracy
    tuple, predictions by question id, first words by question id, the
    launches)."""
    cfg = copy.deepcopy(cfg)
    cfg.tpu.update(tpu)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        accs = tvalidate.run(cfg, 1, feature_stores=stores)
    torch.cuda.synchronize()
    launches = launch_counts()
    check("Test Accuracy" in out.getvalue(), "validate.run printed no Test Accuracy")
    preds = json.load(open(os.path.join(cfg.dataset.save_dir, cfg.exp_name, "preds", "test_preds.json")))
    check(len(preds) == CLI_SPLITS["test"], f"test_preds.json holds {len(preds)} entries")
    return (accs, {p["question_id"]: p["prediction"] for p in preds},
            {p["question_id"]: p["question"][0] for p in preds}, launches)


def cli_agreement(tag, accs, preds, ref_accs, ref_preds, first):
    """The overall and per-bucket accuracy of a run against a reference
    run: each may differ by at most the rows whose predictions differ,
    over the rows it counts. Returns the argmax agreement."""
    differ = {q for q in ref_preds if preds[q] != ref_preds[q]}
    buckets = [set(ref_preds)] + [{q for q in ref_preds if first[q] == w} for w in BUCKET_WORDS]
    for name, a, r, rows in zip(("all",) + BUCKET_WORDS, accs, ref_accs, buckets):
        check(abs(a - r) <= len(differ & rows) / max(len(rows), 1) + 1e-12,
              f"{tag}: {name} accuracy {a} against {r} with {len(differ & rows)} of {len(rows)} rows differing")
    return 1.0 - len(differ) / len(ref_preds)


def state_fields(state):
    """Every field a checkpoint holds, as CPU tensors and numbers."""
    adam = state.adam.state_dict()
    return ({k: v.cpu() for k, v in state.model.state_dict().items()},
            {(i, k): v.cpu() for i, s in adam["state"].items() for k, v in s.items()},
            (state.step, state.updates, state.mini_step), [a.cpu() for a in state.acc_grads],
            state.generator.get_state())


def cli_checkpoint(cfg, state, vocab, batch, root):
    """The final train state saved and restored on the card: every field
    bit for bit, then one step's loss and module gradient norms from the
    restored state against a step from the saved one, on the same batch
    and the same dropout draws (the generators restored)."""
    ckpt = os.path.join(root, "ckpt_check")
    save_checkpoint(ckpt, CLI_EPOCHS - 1, state, model_kwargs_tosave(cfg))
    twin = create_train_state(ttrain.build_model(cfg, vocab, "cuda"), state.optimizer, seed=1)
    restore_checkpoint(ckpt, twin)
    (sa, aa, ca, ga, gen_a), (sb, ab, cb, gb, gen_b) = state_fields(state), state_fields(twin)
    check(sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa), "restored params differ")
    check(aa.keys() == ab.keys() and all(torch.equal(aa[k], ab[k]) for k in aa), "restored Adam moments differ")
    check(ca == cb and len(ga) == len(gb) and all(torch.equal(x, y) for x, y in zip(ga, gb)),
          f"restored counts {cb} against {ca}")
    check(torch.equal(gen_a, gen_b), "restored generator state differs")
    m_a = forward_backward(state, batch, alpha=ALPHA, beta=BETA)
    gn_a = module_grad_norms(state.model)
    m_b = forward_backward(twin, batch, alpha=ALPHA, beta=BETA)
    gn_b = module_grad_norms(twin.model)
    rel_loss = abs(m_a["loss"].item() - m_b["loss"].item()) / max(abs(m_a["loss"].item()), 1e-9)
    rel_gn = max(abs(gn_a[k] - gn_b[k]) / max(gn_a[k], 1e-12) for k in gn_a)
    check(rel_loss <= TOL_TRAIN_LOSS, f"step from the restored state: loss rel {rel_loss:.2e}")
    check(rel_gn <= TOL_TRAIN_GNORM, f"step from the restored state: module gradient norm rel {rel_gn:.2e}")
    state.model.zero_grad(set_to_none=True)
    del twin
    return rel_loss, rel_gn


def host_batches(loader):
    for b in loader:
        yield (b.appearance_feat, b.motion_feat, b.question, b.question_len, b.answer, b.valid)


def epoch_through(state, batches, cfg):
    """One training epoch as the train CLI runs it: host ``batches``
    through ``prefetch_to_device`` into ``train_step``."""
    for batch in prefetch_to_device(batches, "cuda", size=cfg.tpu.prefetch):
        train_step(state, batch, alpha=ALPHA, beta=BETA)


def timed_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def host_copy_ms(loader, store, reps=5):
    """One batch's features from ``store`` as the loader assembles them
    (gathered, cast to the transfer dtype where the store's differs, into
    a pinned tensor; ms, host clock) and their host-to-device copy (ms,
    CUDA events). Returns the two times and the batch's bytes."""
    rows = np.random.RandomState(3).randint(0, CLI_VIDEOS, BATCH)
    pinned = loader._gather(store, rows)
    t0 = time.perf_counter()
    for _ in range(reps):
        pinned = loader._gather(store, rows)
    gather_ms = (time.perf_counter() - t0) / reps * 1e3
    check(pinned.is_pinned(), "the loader's batch is not pinned")
    dev = torch.empty(pinned.shape, dtype=pinned.dtype, device="cuda")
    copy_ms = time_ms(lambda: dev.copy_(pinned, non_blocking=True), reps)
    check(torch.equal(dev.cpu(), pinned), "the pinned batch's copy differs")
    return gather_ms, copy_ms, pinned.numel() * pinned.element_size()


def validation_rate(cfg, state, loader, reps=2):
    """QA/s of ``validate_lib.validate`` through ``loader`` (host clock to
    the last answer), after one warm pass."""
    validate_lib.validate(cfg, pred_step, state, loader, device="cuda", prefetch=cfg.tpu.prefetch)
    t0 = time.perf_counter()
    for _ in range(reps):
        validate_lib.validate(cfg, pred_step, state, loader, device="cuda", prefetch=cfg.tpu.prefetch)
    return reps * loader.num_samples / (time.perf_counter() - t0)


def phase_cli(root, model_ms):
    """The train CLI for two epochs, then the validate CLI on the
    best checkpoint, kernel path and plain path (phase ``cli``); the
    launches of kernels 1-4 counted over each CLI's run."""
    t_phase = time.perf_counter()
    cfg_path, all_stores = cli_dataset(root)
    stores = all_stores["float32"]
    raw = cfg_from_file(cfg_path)
    cfg = copy.deepcopy(raw)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    cfg.alpha, cfg.beta, cfg.unit_layers = ALPHA, BETA, 1
    cfg = resolve_dataset_paths(cfg)

    n_steps = CLI_EPOCHS * -(-CLI_SPLITS["train"] // BATCH)
    n_val = CLI_EPOCHS * -(-CLI_SPLITS["val"] // BATCH)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        best_val, state = ttrain.train(cfg, feature_stores=stores)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    want = tuple(a * n_steps + b * n_val for a, b in zip(TRAIN_LAUNCHES["float32"], EVAL_LAUNCHES["float32"]))
    check(launches == want, f"train() ran {n_steps} steps and {n_val} validation forwards with launches "
                            f"{launches}, want {want}")
    check(0.0 < best_val <= 1.0, f"best val accuracy {best_val}: no best checkpoint")
    log = os.path.join(cfg.dataset.save_dir, "log", "metrics.jsonl")
    records = [json.loads(ln) for ln in open(log)]
    train_recs = [r for r in records if r["type"] == "train"]
    val_recs = [r for r in records if r["type"] == "val"]
    check(len(train_recs) == n_steps and len(val_recs) == CLI_EPOCHS,
          f"metrics_jsonl: {len(train_recs)} train and {len(val_recs)} val records")
    check(all(set(r) == CLI_TRAIN_KEYS for r in train_recs) and all(set(r) == CLI_VAL_KEYS for r in val_recs),
          "metrics_jsonl records lack the JAX train.py's fields")
    check(all(np.isfinite(r["ce"]) for r in train_recs), "non-finite ce in metrics_jsonl")
    traces = os.listdir(cfg.tpu.profile_dir)
    check(traces == [f"trace_epoch{CLI_EPOCHS - 1}.json"], f"profile_dir holds {traces}")

    # the checkpoint on the card
    loader = ttrain.make_loader(cfg, cfg.dataset.train_question_pt, shuffle=False, device="cuda",
                                feature_stores=stores)
    b = next(iter(loader))
    batch = tuple(torch.as_tensor(x).cuda() for x in (b.appearance_feat, b.motion_feat, b.question,
                                                       b.question_len, b.answer, b.valid))
    rel_loss, rel_gn = cli_checkpoint(cfg, state, loader.vocab, batch, root)
    del batch, b

    # the validate CLI: kernel path, then plain path, same checkpoint
    accs, preds, first, val_launches = cli_run_validate(raw, stores)
    n_fwd = -(-CLI_SPLITS["test"] // BATCH)
    want = tuple(n * n_fwd for n in EVAL_LAUNCHES["float32"])
    check(val_launches == want, f"validate.run launched {val_launches}, want {want}")
    plain_accs, plain_preds, _, plain_launches = cli_run_validate(raw, stores, use_pallas=False)
    check(plain_launches == (0,) * len(COUNTED_KERNELS), f"the plain path launched {plain_launches}")
    agree = cli_agreement("cli kernel vs plain", accs, preds, plain_accs, plain_preds, first)
    check(agree >= MIN_ARGMAX_AGREEMENT, f"cli: argmax agreement {agree} < {MIN_ARGMAX_AGREEMENT}")

    # rates through the loader, beside the model alone; and an epoch of the
    # same batches gathered beforehand (no producer thread beside the steps)
    epoch_through(state, host_batches(loader), cfg)  # warm
    epoch_s = timed_s(lambda: epoch_through(state, host_batches(loader), cfg))
    gathered = list(host_batches(loader))
    pregathered_s = timed_s(lambda: epoch_through(state, iter(gathered), cfg))
    del gathered
    profile_run("cli train epoch profile", lambda: epoch_through(state, host_batches(loader), cfg))
    val_qa_s = validation_rate(cfg, state, loader)
    gather_app, copy_app, bytes_app = host_copy_ms(loader, stores[0])
    gather_mot, copy_mot, bytes_mot = host_copy_ms(loader, stores[1])
    say("cli", seconds=f"{time.perf_counter() - t_phase:.1f}", train_s=f"{train_s:.2f}", epochs=CLI_EPOCHS, steps=n_steps, best_val=f"{best_val:.4f}",
        test_acc=f"{accs[0]:.4f}", plain_test_acc=f"{plain_accs[0]:.4f}", argmax_agreement=f"{agree:.4f}",
        restore_bit_exact=True, restored_step_rel_loss=f"{rel_loss:.2e}", restored_step_gnorm_rel=f"{rel_gn:.2e}",
        launches_train=",".join(f"{k.__name__}:{n}" for k, n in zip(COUNTED_KERNELS, launches) if n),
        launches_validate=",".join(f"{k.__name__}:{n}" for k, n in zip(COUNTED_KERNELS, val_launches) if n))
    say("cli rates", epoch_s=f"{epoch_s:.3f}", epoch_qa_per_s=f"{CLI_SPLITS['train'] / epoch_s:.1f}",
        step_ms_through_loader=f"{epoch_s / (n_steps // CLI_EPOCHS) * 1e3:.3f}",
        epoch_s_pregathered=f"{pregathered_s:.3f}",
        train_step_ms_model_alone=f"{model_ms['train']:.3f}",
        val_qa_per_s=f"{val_qa_s:.1f}", eval_qa_per_s_model_alone=f"{BATCH / model_ms['eval'] * 1e3:.1f}",
        gather_ms_per_batch=f"{gather_app + gather_mot:.3f}", gather_app_ms=f"{gather_app:.3f}",
        h2d_ms_per_batch=f"{copy_app + copy_mot:.3f}", h2d_gb_per_s=f"{(bytes_app + bytes_mot) / (copy_app + copy_mot) / 1e6:.2f}",
        batch_mb=f"{(bytes_app + bytes_mot) / 1e6:.1f}", cpu_count=os.cpu_count(),
        h5py_importable=importlib.util.find_spec("h5py") is not None)
    phase_native_gather(cfg, state, stores)
    del state
    torch.cuda.empty_cache()
    return raw, all_stores, launches, val_launches, accs, preds, first


class IndexSelectStore(FeatureStore):
    """A cached store that gathers as the loader did before the native
    gather: one ``torch.index_select`` into the pinned batch (the gather's
    plain version)."""

    @classmethod
    def of(cls, store):
        self = cls.__new__(cls)
        self.__dict__.update(store.__dict__)
        return self

    def gather(self, rows, out=None, n_threads=None):
        return native.gather_rows_reference(self._cache, rows, out=out)


GATHER_THREADS = (1, 2, 4, 8)


def in_turns(variants, reps=3):
    """Host ms of each of ``variants`` ({name: fn}) over ``reps`` calls
    after one warm-up, in turns: the order forward, then backward."""
    times = {k: [] for k in variants}
    for order in (list(variants), list(variants)[::-1]):
        for k in order:
            variants[k]()
            t0 = time.perf_counter()
            for _ in range(reps):
                variants[k]()
            times[k].append((time.perf_counter() - t0) / reps * 1e3)
    return times


def phase_native_gather(cfg, state, stores):
    """Phase ``native gather``: on phase cli's flagship-sized fp32 store, a
    batch of 256 appearance rows gathered into one pinned tensor by the
    native gather at 1, 2, 4 and 8 threads and by ``torch.index_select``,
    in turns, each result checked bit-equal; the per-batch fp32 -> bf16
    cast, native against torch; and the training epoch through the loader
    with ``num_workers`` 8 (native) against the loader's gather before it
    (index_select), in turns (plain, native, native, plain)."""
    t_phase = time.perf_counter()
    src = stores[0]._cache
    rows = np.random.RandomState(3).randint(0, CLI_VIDEOS, BATCH)
    pinned = torch.empty((BATCH, *src.shape[1:]), dtype=src.dtype, pin_memory=True)
    want = native.gather_rows_reference(src, rows)

    def checked(fn):
        def run():
            fn()
            check(torch.equal(pinned, want), "a gather into the pinned batch differs from index_select")
        return run

    variants = {"index_select": lambda: native.gather_rows_reference(src, rows, out=pinned)}
    variants.update({f"native_{t}": (lambda t=t: native.gather_rows(src, rows, out=pinned, n_threads=t))
                     for t in GATHER_THREADS})
    for fn in variants.values():
        checked(fn)()
    gather = in_turns(variants)

    out16 = torch.empty(pinned.shape, dtype=torch.bfloat16, pin_memory=True)
    want16 = pinned.to(torch.bfloat16)
    native.cast_f32_to_bf16(pinned, out=out16)
    check(torch.equal(out16.view(torch.int16), want16.view(torch.int16)), "the native cast differs from torch's")
    cast = in_turns({"torch": lambda: out16.copy_(pinned), "native_8": lambda: native.cast_f32_to_bf16(
        pinned, out=out16, n_threads=8)})

    loaders = {}
    for name, wrap, workers in (("index_select", IndexSelectStore.of, 0), ("native_8", lambda st: st, 8)):
        c = copy.deepcopy(cfg)
        c.num_workers = workers
        loaders[name] = ttrain.make_loader(c, c.dataset.train_question_pt, shuffle=False, device="cuda",
                                           feature_stores=tuple(wrap(st) for st in stores))
    epochs = {k: [] for k in loaders}
    for name in ("index_select", "native_8", "native_8", "index_select"):
        epochs[name].append(timed_s(lambda: epoch_through(state, host_batches(loaders[name]), cfg)))
    loader_gather = {k: host_copy_ms(ld, ld.app_store)[0] for k, ld in loaders.items()}
    fmt = lambda v: "/".join(f"{x:.3f}" for x in v)  # noqa: E731
    say("native gather", seconds=f"{time.perf_counter() - t_phase:.1f}", batch=BATCH,
        batch_mb=f"{pinned.numel() * 4 / 1e6:.1f}", cpu_count=os.cpu_count(), bit_equal=True,
        **{f"gather_ms_{k}": fmt(v) for k, v in gather.items()},
        **{f"cast_ms_{k}": fmt(v) for k, v in cast.items()},
        **{f"epoch_s_{k}": fmt(v) for k, v in epochs.items()},
        **{f"loader_gather_app_ms_{k}": f"{v:.3f}" for k, v in loader_gather.items()},
        parent_recorded="epoch 361 ms, gather 49.77 ms a batch (PERF.md, not measured by this run)")


def phase_cli_bf16(raw, all_stores, accs, preds, first, model_ms):
    """The validate CLI in bf16 (compute and transfer) on the same
    checkpoint, against the fp32 kernel path: its launches, and the bf16
    limits on the test split's logits (computed beside it through
    ``validate_lib.validate`` from the same checkpoint)."""
    t_phase = time.perf_counter()
    stores = all_stores["bfloat16"]
    bf16 = dict(compute_dtype="bfloat16", transfer_dtype="bfloat16")
    b_accs, b_preds, _, launches = cli_run_validate(raw, stores, **bf16)
    n_fwd = -(-CLI_SPLITS["test"] // BATCH)
    want = tuple(n * n_fwd for n in EVAL_LAUNCHES["bfloat16"])
    check(launches == want, f"bf16 validate.run launched {launches}, want {want}")

    # the logits of both paths from the best checkpoint
    cfg = copy.deepcopy(raw)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    cfg.unit_layers = 1
    cfg = resolve_dataset_paths(cfg)
    logits = {}
    state = None
    for dtype in ("float32", "bfloat16"):
        cfg.tpu.transfer_dtype = dtype
        loader = ttrain.make_loader(cfg, cfg.dataset.test_question_pt, shuffle=False, device="cuda",
                                    feature_stores=all_stores[dtype])
        if state is None:
            state = create_train_state(ttrain.build_model(cfg, loader.vocab, "cuda"),
                                       make_optimizer(cfg.train.lr, len(loader)), seed=0)
            restore_checkpoint(os.path.join(cfg.dataset.save_dir, "ckpt"), state)
            state.model.eval()
        state.model.compute_dtype = dtype
        rows = []

        def keep_logits(s, inputs):
            rows.append(s.model(*map(torch.as_tensor, inputs)).logits)
            return rows[-1]

        validate_lib.validate(cfg, keep_logits, state, loader, device="cuda")
        logits[dtype] = torch.cat(rows)[: CLI_SPLITS["test"]]
    qids = sorted(preds)  # the loader's order: question ids ascending
    ref, got = logits["float32"], logits["bfloat16"]
    scale, err = ref.abs().max().item(), max_err(got, ref)
    check(err <= TOL_BF16_LOGITS * scale, f"cli bf16 logits max abs err {err:.3e} > {TOL_BF16_LOGITS} * {scale:.3e}")
    top2 = ref.topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    flips = [i for i, q in enumerate(qids) if b_preds[q] != preds[q]]
    unexplained = [i for i in flips if margin[i] > 2 * err]
    check(not unexplained, f"cli bf16: {len(unexplained)} argmax flips on rows whose fp32 top-2 margin exceeds "
                           f"2 x {err:.3e}")
    agree = cli_agreement("cli bf16 vs fp32", b_accs, b_preds, accs, preds, first)
    cfg.tpu.compute_dtype = cfg.tpu.transfer_dtype = "bfloat16"
    loader = ttrain.make_loader(cfg, cfg.dataset.train_question_pt, shuffle=False, device="cuda",
                                feature_stores=stores)
    state.model.train()
    val_qa_s = validation_rate(cfg, state, loader)
    gather_app, copy_app, bytes_app = host_copy_ms(loader, stores[0])
    gather_mot, copy_mot, bytes_mot = host_copy_ms(loader, stores[1])
    # context: the same batch gathered from the fp32 store and cast on the host
    cast_app, _, _ = host_copy_ms(loader, all_stores["float32"][0])
    cast_mot, _, _ = host_copy_ms(loader, all_stores["float32"][1])
    say("cli bf16", seconds=f"{time.perf_counter() - t_phase:.1f}", test_acc=f"{b_accs[0]:.4f}", fp32_test_acc=f"{accs[0]:.4f}", argmax_agreement=f"{agree:.4f}",
        flips=len(flips), logits_max_abs_err=f"{err:.3e}", rel_to_max_logit=f"{err / scale:.3e}",
        tol=f"{TOL_BF16_LOGITS}*max|logit|",
        launches_validate=",".join(f"{k.__name__}:{n}" for k, n in zip(COUNTED_KERNELS, launches) if n),
        val_qa_per_s=f"{val_qa_s:.1f}", eval_bf16_qa_per_s_model_alone=f"{BATCH / model_ms['eval bf16'] * 1e3:.1f}",
        gather_ms_per_batch=f"{gather_app + gather_mot:.3f}", gather_app_ms=f"{gather_app:.3f}",
        h2d_ms_per_batch=f"{copy_app + copy_mot:.3f}", batch_mb=f"{(bytes_app + bytes_mot) / 1e6:.1f}",
        gather_cast_from_fp32_store_ms_per_batch=f"{cast_app + cast_mot:.3f}")
    return launches


# served answers against the validate CLI's: top-1 equal except where the
# served top two log-probabilities lie within this of each other (a batch
# of 32 and validate's 256 take other kernel plans: sums in another order)
HTTP_TIE_LOG_MARGIN = 1e-3
# two routes of the same program: the replies' scores are rounded to 6
# decimals, so within one unit of the last place
HTTP_ROUTE_ATOL = 1e-6
HTTP_THREADS = 64


def http_request(port, path, body=None):
    """(status, JSON reply) of a GET, or of a POST of ``body`` (bytes)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST" if body else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# the HTTP clients: a process of their own (so that they share no
# interpreter lock with the server), HTTP_THREADS threads, stdlib only;
# argv: port, threads; stdin: [[video id, question], ...]; stdout: the
# [status, reply] of each, in order
HTTP_CLIENT = """
import json, sys, urllib.error, urllib.request
from concurrent.futures import ThreadPoolExecutor
port, threads = int(sys.argv[1]), int(sys.argv[2])
def post(vq):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/answer", method="POST",
                                 data=json.dumps({"video_id": vq[0], "question": vq[1]}).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
with ThreadPoolExecutor(threads) as pool:
    json.dump(list(pool.map(post, json.load(sys.stdin))), sys.stdout)
"""


def http_serve(tag, engine, answer_fn, questions):
    """``questions`` ((video id, text), ...) POSTed from HTTP_THREADS
    threads of a client process to a server on 127.0.0.1 around
    ``engine``, after a warm-up; every reply 200. Returns (replies,
    launches, batches, stats, wall s)."""
    tserve.warm_up(engine, 1)
    srv = tserve.make_server("127.0.0.1", 0, engine, answer_fn)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    port = srv.server_address[1]
    try:
        before = engine.stats()["batches"]
        reset_counts()
        t0 = time.perf_counter()
        client = subprocess.run([sys.executable, "-c", HTTP_CLIENT, str(port), str(HTTP_THREADS)],
                                input=json.dumps(questions), capture_output=True, text=True, timeout=600)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(client.returncode == 0, f"{tag}: the client exited {client.returncode}: {client.stderr[-2000:]}")
        replies = [tuple(r) for r in json.loads(client.stdout)]
        launches = launch_counts()
        stats = engine.stats()
        batches = stats["batches"] - before
        bad = [r for r in replies if r[0] != 200]
        check(not bad, f"{tag}: {len(bad)} replies not 200, e.g. {bad[:2]}")
        want = tuple(n * batches for n in EVAL_LAUNCHES["float32"])
        check(launches == want, f"{tag}: {launches} launches over {batches} batches, want {want}")
        # the front's other answers
        check(http_request(port, "/healthz") == (200, {"ok": True}), f"{tag}: /healthz")
        code, served = http_request(port, "/stats")
        check(code == 200 and served["requests"] == stats["requests"], f"{tag}: /stats {code} {served}")
        code, _ = http_request(port, "/answer", json.dumps({"video_id": "1", "question": "what?"}).encode())
        check(code == 404, f"{tag}: an unknown video gave {code}")
        code, _ = http_request(port, "/answer", b"{not json")
        check(code == 400, f"{tag}: a bad body gave {code}")
    finally:
        srv.shutdown()
        srv.server_close()
        server.join(timeout=10)
        engine.close()
    return replies, launches, batches, stats, wall


def same_route_answers(tag, replies, ref):
    """Two routes of the same program: scores within HTTP_ROUTE_ATOL, top-1
    equal except where the reference's top two scores tie."""
    for (_, got), (_, want) in zip(replies, ref):
        g = np.array([t["score"] for t in got["topk"]])
        w = np.array([t["score"] for t in want["topk"]])
        check(np.abs(g - w).max() <= HTTP_ROUTE_ATOL + 1e-12, f"{tag}: scores {g} against {w}")
        check(got["answer"] == want["answer"] or w[0] - w[1] <= HTTP_ROUTE_ATOL, f"{tag}: other top-1")


def phase_http(root, raw, stores, preds, export_path):
    """The HTTP front on the train CLI's checkpoint and the phase's
    in-memory stores: the test split's questions as text, POSTed from
    concurrent threads; the answers against the validate CLI's; then the
    same checkpoint exported for cuda and served from the artifact, and the
    export phase's artifact served over the same front. Returns the
    launches of all three routes."""
    t_phase = time.perf_counter()
    cfg = copy.deepcopy(raw)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    paths = resolve_dataset_paths(cfg).dataset
    vocab = load_vocab(paths.vocab_json)
    with open(paths.test_question_pt, "rb") as f:
        obj = pickle.load(f)
    words = vocab["question_idx_to_token"]
    qids = list(obj["question_id"])
    questions = [(str(v), " ".join(words[int(w)] for w in q[:n]) + "?")
                 for v, q, n in zip(obj["video_ids"], obj["questions"], obj["questions_len"])]

    engine, answer_fn, _ = tserve.build_engine(cfg, 1, SERVE_BATCH, 5.0, TOP_K, max_q_len=QLEN,
                                               feature_stores=stores)
    replies, launches, batches, stats, wall = http_serve("http", engine, answer_fn, questions)
    ties = 0
    for qid, (_, out) in zip(qids, replies):
        p = [t["score"] for t in out["topk"]]
        tie = np.log(p[0]) - np.log(p[1]) <= HTTP_TIE_LOG_MARGIN
        ties += tie
        check(out["answer"] == preds[qid] or tie, f"http: question {qid} answered {out['answer']}, validate "
                                                  f"{preds[qid]}")
    agree = np.mean([out["answer"] == preds[qid] for qid, (_, out) in zip(qids, replies)])
    say("http", seconds=f"{time.perf_counter() - t_phase:.1f}", questions=len(questions), batches=batches,
        mean_batch=f"{len(questions) / batches:.2f}", threads=HTTP_THREADS,
        agreement_with_validate=f"{agree:.4f}", near_ties=int(ties), p50_ms=f"{stats['latency_ms_p50']:.2f}",
        p99_ms=f"{stats['latency_ms_p99']:.2f}", qa_per_s=f"{len(questions) / wall:.1f}",
        launches=fmt_launches(launches))

    # the same checkpoint through the export (as python -m dualvgr_tpu_torch.export does) and the artifact route
    model, _ = model_from_checkpoint(cfg, 1)
    vd = FLAGSHIP["vision_dim"]
    t0 = time.perf_counter()
    payload, meta = export_serving(model, max_batch=SERVE_BATCH, app_shape=(CLIPS, FRAMES, vd), mot_shape=(CLIPS, vd),
                                   max_q_len=QLEN, top_k=TOP_K, platforms=("cuda",))
    export_s = time.perf_counter() - t0
    cli_path = os.path.join(root, "cli.dvgr")
    save_artifact(cli_path, payload, meta)
    del model, payload
    engine, answer_fn, _ = tserve.build_engine_from_artifact(cfg, cli_path, 5.0, feature_stores=stores)
    art_replies, art_launches, art_batches, art_stats, art_wall = http_serve("http artifact", engine, answer_fn,
                                                                             questions)
    same_route_answers("http artifact vs checkpoint", art_replies, replies)

    # the export phase's artifact (the seed-0 flagship weights) over the same front, against its own predict fn
    engine, answer_fn, _ = tserve.build_engine_from_artifact(cfg, export_path, 5.0, feature_stores=stores)
    few = questions[:2 * SERVE_BATCH]
    exp_replies, exp_launches, _, _, _ = http_serve("http export artifact", engine, answer_fn, few)
    predict, _ = load_artifact(export_path)
    q_ids = vocab["question_token_to_idx"]
    reqs = [(stores[0].row(v).numpy(), stores[1].row(v).numpy(),
             np.asarray(encode_tokens(tokenize_question(text), q_ids), np.int32)) for v, text in few]
    direct = direct_answers(predict, reqs)
    del predict
    for (_, out), (ids, scores) in zip(exp_replies, direct):
        got = np.array([t["score"] for t in out["topk"]])
        check(np.abs(got - scores).max() <= HTTP_ROUTE_ATOL, f"http export artifact: scores {got} against {scores}")
        check(out["answer"] == vocab["answer_idx_to_token"][int(ids[0])] or scores[0] - scores[1] <= HTTP_ROUTE_ATOL,
              "http export artifact: other top-1")
    torch.cuda.empty_cache()
    total = tuple(a + b + c for a, b, c in zip(launches, art_launches, exp_launches))
    say("http artifact", export_s=f"{export_s:.2f}", artifact_mb=f"{os.path.getsize(cli_path) / 1e6:.1f}",
        batches=art_batches, p50_ms=f"{art_stats['latency_ms_p50']:.2f}",
        p99_ms=f"{art_stats['latency_ms_p99']:.2f}", qa_per_s=f"{len(questions) / art_wall:.1f}",
        launches=fmt_launches(art_launches), export_phase_artifact_questions=len(few),
        export_phase_artifact_launches=fmt_launches(exp_launches))
    return total


# --- the GCN graph module (graph_module: GCN, the config's default) and
# the stacked-bank GAT path ---


@torch.no_grad()
def phase_gcn(app, mot, q, qlen):
    """Phases ``gcn`` and ``gcn bf16``: the GCN DualVGR at the flagship
    width, seed 0; the fp32 forward, kernel path against plain path, then
    the bf16 forward against it. Returns ({tag: ms}, {tag: launches of one
    forward})."""
    model = build_model(seed=0, graph_module="GCN", **FLAGSHIP)
    check(type(model.visual_input_unit.acGCN[0]).__name__ == "PunishGCN", "the GCN model holds no PunishGCN banks")
    ms, logits, launches = phase_eval(model, app, mot, q, qlen, tag="gcn", want=GCN_EVAL_LAUNCHES["float32"])
    ms16, launches16 = phase_eval_bf16(model, app, mot, q, qlen, logits, tag="gcn bf16",
                                       want=GCN_EVAL_LAUNCHES["bfloat16"])
    del model, logits
    torch.cuda.empty_cache()
    return {"gcn": ms, "gcn bf16": ms16}, {"gcn": launches, "gcn bf16": launches16}


def grad_errors(grads, ref):
    """Each parameter's max |grad - ref| over the largest |ref| of its
    top-level module: a softmax bias's gradient is the residue of a sum
    that cancels, so it is not held relative to itself."""
    scale = {}
    for k, g in ref.items():
        top = k.split(".")[0]
        scale[top] = max(scale.get(top, 1e-12), g.abs().max().item())
    return {k: (grads[k] - g).abs().max().item() / scale[k.split(".")[0]] for k, g in ref.items()}


def phase_batch_gats(batch):
    """Phase ``batch_gats``: the GAT flagship with ``batch_gats`` (the four
    banks of a graph layer as one stacked computation) against the
    per-module path, from the same weights after 2 warm-up steps, dropout
    off: one train step's loss (1e-4 relative) and every gradient (1e-3 of
    its module's largest); the plain eval forward (the eval limits); and
    the kernel eval of the stacked model, which still launches kernel 2
    twice. Returns the kernel eval's launches."""
    lr = cfg_from_file(TRAIN_CFG).train.lr
    model = build_model(seed=0, **FLAGSHIP)
    vu = model.visual_input_unit
    state = create_train_state(model, make_optimizer(lr, steps_per_epoch=100), seed=0)
    for _ in range(WARMUP_STEPS):
        train_step(state, batch, alpha=ALPHA, beta=BETA)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    runs = {}
    for stacked in (False, True):
        vu.batch_gats = stacked
        reset_counts()
        loss = forward_backward(state, batch, alpha=ALPHA, beta=BETA)["loss"].item()
        torch.cuda.synchronize()
        runs[stacked] = (loss, {k: p.grad.clone() for k, p in model.named_parameters()}, launch_counts())
        runs[stacked] += (time_ms(lambda: forward_backward(state, batch, alpha=ALPHA, beta=BETA), 3),)
    (loss_a, grads_a, launch_a, ms_a), (loss_b, grads_b, launch_b, ms_b) = runs[False], runs[True]
    check(launch_a == launch_b == TRAIN_LAUNCHES["float32"], f"batch_gats train launches {launch_a} / {launch_b}")
    rel_loss = abs(loss_b - loss_a) / max(abs(loss_a), 1e-9)
    check(np.isfinite(loss_b) and rel_loss <= TOL_TRAIN_LOSS, f"batch_gats loss {loss_b} against {loss_a}")
    errs = grad_errors(grads_b, grads_a)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= TOL_TRAIN_GNORM, f"batch_gats gradient {worst}: {errs[worst]:.2e} > {TOL_TRAIN_GNORM}")
    model.zero_grad(set_to_none=True)
    del grads_a, grads_b, state

    model.eval()
    app, mot, q, qlen = batch[:4]
    with torch.no_grad():
        model.use_kernels = False
        outs, plain_ms = {}, {}
        for stacked in (False, True):
            vu.batch_gats = stacked
            outs[stacked] = model(app, mot, q, qlen)
            plain_ms[stacked] = time_ms(lambda: model(app, mot, q, qlen), 3)
        ref, got = outs[False], outs[True]
        scale = ref.logits.abs().max().item()
        err = max_err(got.logits, ref.logits)
        check(err <= TOL_LOGITS * scale, f"batch_gats eval logits {err:.3e} > {TOL_LOGITS} * {scale:.3e}")
        aux = max(max_err(getattr(got, f), getattr(ref, f)) / max(1.0, getattr(ref, f).abs().max().item())
                  for f in ref._fields[1:])
        check(aux <= TOL_GAT, f"batch_gats eval aux outputs {aux:.3e} > {TOL_GAT}")
        model.use_kernels = True
        reset_counts()
        model(app, mot, q, qlen)
        torch.cuda.synchronize()
        launches = launch_counts()
    check(launches == EVAL_LAUNCHES["float32"], f"the batch_gats kernel eval launched {launches}")
    say("batch_gats", after_steps=WARMUP_STEPS, rel_loss=f"{rel_loss:.2e}", tol_loss=TOL_TRAIN_LOSS,
        worst_grad=worst, worst_grad_rel=f"{errs[worst]:.2e}", tol_grad=TOL_TRAIN_GNORM,
        eval_logits_max_abs_err=f"{err:.3e}", eval_aux_rel_err=f"{aux:.3e}",
        fwd_bwd_ms_per_module=f"{ms_a:.3f}", fwd_bwd_ms_stacked=f"{ms_b:.3f}",
        plain_eval_ms_per_module=f"{plain_ms[False]:.3f}", plain_eval_ms_stacked=f"{plain_ms[True]:.3f}",
        kernel_eval_launches=f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]}")
    del model, outs
    torch.cuda.empty_cache()
    return launches


def phase_gcn_cli(root, stores):
    """Phase ``gcn cli``: phase ``cli``'s dataset under a config with no
    ``graph_module`` key (so the default, GCN), trained for 1 epoch and
    validated through the CLIs' library entries; the checkpoint exported for
    cuda, and phase ``serve``'s 64 requests through the loaded artifact
    against the live program. Returns the launches of each part."""
    t_phase = time.perf_counter()
    lines = open(os.path.join(root, "cli_smoke.yml")).read().splitlines()
    kept = [ln for ln in lines if not ln.startswith("graph_module")]
    check(len(kept) == len(lines) - 1, "phase cli's config names no graph_module")
    kept = [("exp_name: 'cliSmokeGCN'" if ln.startswith("exp_name") else
             "  max_epochs: 1" if ln.strip().startswith("max_epochs") else ln) for ln in kept]
    cfg_path = os.path.join(root, "cli_gcn.yml")
    with open(cfg_path, "w") as f:
        f.write("\n".join(kept) + "\n")
    raw = cfg_from_file(cfg_path)
    check(raw.graph_module == "GCN", f"the default graph_module is {raw.graph_module!r}")
    cfg = copy.deepcopy(raw)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    cfg.alpha, cfg.beta, cfg.unit_layers = ALPHA, BETA, 1
    cfg = resolve_dataset_paths(cfg)

    n_steps, n_val = -(-CLI_SPLITS["train"] // BATCH), -(-CLI_SPLITS["val"] // BATCH)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        best_val, state = ttrain.train(cfg, feature_stores=stores)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = launch_counts()
    want = tuple(a * n_steps + b * n_val for a, b in zip(TRAIN_LAUNCHES["float32"], GCN_EVAL_LAUNCHES["float32"]))
    check(train_launches == want, f"gcn train() launched {train_launches}, want {want}")
    check(type(state.model.visual_input_unit.acGCN[0]).__name__ == "PunishGCN", "gcn cli trained no GCN")
    kw = load_model_kwargs(os.path.join(cfg.dataset.save_dir, "ckpt"))
    check(kw["graph_module"] == "GCN", f"model_kwargs.json says graph_module={kw['graph_module']!r}")
    del state
    accs, _, _, val_launches = cli_run_validate(raw, stores)
    want = tuple(n * -(-CLI_SPLITS["test"] // BATCH) for n in GCN_EVAL_LAUNCHES["float32"])
    check(val_launches == want, f"gcn validate.run launched {val_launches}, want {want}")

    # the checkpoint exported for cuda (as python -m dualvgr_tpu_torch.export does) and served
    model, _ = model_from_checkpoint(cfg, 1)
    check(type(model.visual_input_unit.acGCN[0]).__name__ == "PunishGCN", "model_from_checkpoint built no GCN")
    vd = FLAGSHIP["vision_dim"]
    t0 = time.perf_counter()
    payload, meta = export_serving(model, max_batch=SERVE_BATCH, app_shape=(CLIPS, FRAMES, vd),
                                   mot_shape=(CLIPS, vd), max_q_len=QLEN, top_k=TOP_K, platforms=("cuda",))
    export_s = time.perf_counter() - t0
    path = os.path.join(root, "gcn.dvgr")
    save_artifact(path, payload, meta)
    del payload
    predict, _ = load_artifact(path)
    ops = graph_ops(predict.program)
    kernel_ops = {k: n for k, n in ops.items() if k.startswith("dualvgr_torch.")}
    check(kernel_ops == {"dualvgr_torch.bilstm_recurrence.default": 3, "dualvgr_torch.input_proj_f32.default": 1},
          f"the gcn artifact holds {kernel_ops}")
    check(not ops["aten.chunk.default"], "the gcn artifact holds the plain recurrence")
    reqs = serve_requests()
    direct = direct_answers(build_predict_fn(model, TOP_K), reqs)
    direct_answers(predict, reqs[:SERVE_BATCH])  # warm the loaded program
    serve_launches, stats, wall = serve_through_engine("gcn cli serve", predict, reqs, direct, "float32",
                                                       per_batch=GCN_EVAL_LAUNCHES["float32"])
    say("gcn cli", seconds=f"{time.perf_counter() - t_phase:.1f}", config_graph_module="absent",
        built=kw["graph_module"], train_s=f"{train_s:.2f}", steps=n_steps, best_val=f"{best_val:.4f}",
        test_acc=f"{accs[0]:.4f}", export_s=f"{export_s:.2f}", artifact_mb=f"{os.path.getsize(path) / 1e6:.1f}",
        graph_ops=",".join(f"{k.split('.')[1]}:{n}" for k, n in sorted(kernel_ops.items())),
        requests=stats["requests"], batches=stats["batches"], p50_ms=f"{stats['latency_ms_p50']:.2f}",
        p99_ms=f"{stats['latency_ms_p99']:.2f}", qa_per_s=f"{SERVE_REQUESTS / wall:.1f}",
        launches_train=",".join(f"{k.__name__}:{n}" for k, n in zip(COUNTED_KERNELS, train_launches) if n),
        launches_validate=",".join(f"{k.__name__}:{n}" for k, n in zip(COUNTED_KERNELS, val_launches) if n),
        launches_serve=fmt_launches(serve_launches))
    del model, predict
    torch.cuda.empty_cache()
    return train_launches, val_launches, serve_launches


# --- phases ddp, ddp bf16, tp and ddp nccl: the multi-device layer ---
# The card is one H100, so the multi-rank phases put both ranks on cuda:0
# in a gloo group (NCCL refuses two ranks on one device); gloo stages each
# CUDA collective through the host, so its all-reduce time is not NCCL's.
# Phase ddp nccl runs the train CLI in a one-rank NCCL group.
DDP_RANKS, DDP_STEPS = 2, 3
TP_DEGREE = 2
DDP_TIMEOUT = 600.0
# the DP step's parameters after DDP_STEPS Adam updates against one
# process's (lr 1e-4): each module's update (p - p0) within TOL_DDP_UPDATE
# of one process's, relative to its norm; at most TOL_DDP_FLIP_SHARE of the
# elements beyond DDP_FLIP_ATOL (an element whose gradient is near zero
# takes its Adam step's sign from the sum order); every element within two
# Adam steps a step. Set from a sound run on the H100 (readings: worst
# module 3.4e-4, share 2.0e-5, largest gap 3.2e-5). Ranks that step on
# their own rows' gradients (no all-reduce) read 0.81-1.19 on every module
# (on the CPU at module_dim 64, where the sound run reads 3.7e-4 to 1.0e-2)
TOL_DDP_UPDATE = 3e-3
DDP_FLIP_ATOL = 1e-6
TOL_DDP_FLIP_SHARE = 2e-4


def ddp_batches(steps=DDP_STEPS):
    """Phase train's global batch (seed 1), ``steps`` times: every rank makes
    it alike on the card and takes its rows."""
    b = train_batch(torch.Generator(device="cuda").manual_seed(1))
    return [b] * steps


def ddp_batch_once():
    return ddp_batches(1)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def fmt_counts(launches):
    """The kernels a run launched, by name, with their counts."""
    return ",".join(f"{k.__name__}:{n}" for k, n in zip(COUNTED_KERNELS, launches) if n) or "none"


def nccl_rank(rank, world, init_file, out_file):
    """One rank of an NCCL group on cuda:0: its first all-reduce's result or
    the error NCCL gives, written to ``out_file``."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{init_file}", world_size=world, rank=rank)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        msg = f"all_reduce gave {t.tolist()}"
    except Exception as e:  # the refusal is the result
        msg = f"{type(e).__name__}: {e}"
    with open(out_file, "w") as f:
        f.write(msg)


def phase_nccl_two_ranks():
    """NCCL with two ranks on the one card: the error it gives (why the
    two-rank phases use gloo). Each rank in a process of its own, killed
    after 90 s."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        outs = [os.path.join(d, f"rank{r}.txt") for r in range(DDP_RANKS)]
        procs = [ctx.Process(target=nccl_rank, args=(r, DDP_RANKS, os.path.join(d, "store"), outs[r]), daemon=True)
                 for r in range(DDP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + 90
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        got = [open(o).read() if os.path.exists(o) else f"no result (exit {p.exitcode})" for o, p in zip(outs, procs)]
    refused = all("Duplicate GPU" in g or "invalid usage" in g for g in got)
    say("nccl two ranks", refused=refused, error=repr(" | ".join(g.replace("\n", " ") for g in got)[:600]))


def phase_ddp():
    """Phase train's flagship step on two gloo ranks sharing the card,
    against one process on the same global batch (256 rows, 128 a rank,
    the last 6 padded, dropout on, kernel path, fp32): each step's loss
    (1e-4 relative) and module gradient norms (1e-3), the updated
    parameters (each module's update against one process's, the share of
    elements apart and the largest gap: TOL_DDP_*) and the validation
    forward's argmax (>= 0.99); kernels 3 and 4 three times a step on each
    rank, kernels 1 and 2 three and two times a validation forward; step
    ms per rank with the gradient all-reduced in 25 MB buckets during the
    backward and, in the same call, in one bucket when it ends, and one
    flat all-reduce's ms alone (CUDA events). The gradient norms are
    compared at the last step, after two updates: at the zero-bias init
    QueryAttn's gradient is rounding noise times 1e12 (phase train), and
    the clip scales every module by it. Then
    the same steps in bf16 (kernel 6 once a step; within the bf16 limits of
    the fp32 DP steps), one step under ``tensor_parallel: 2`` with
    ``zero_opt`` (kernels off with the warning logged, sharded leaves, the
    loss within the fp32 limit of the DP step's), the same without ZeRO,
    and one DP step with ZeRO-1: bytes of parameters and Adam state a rank
    holds in each layout. Returns the launches of the DP ranks."""
    from dualvgr_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    lr = cfg_from_file(TRAIN_CFG).train.lr
    base = dict(device="cuda", dims=FLAGSHIP, seed=0, gen_seed=0, tpu=dict(use_pallas=True), lr=lr, alpha=ALPHA,
                beta=BETA, make_batches=ddp_batch_once)
    ddp = dict(base, make_batches=ddp_batches, eval=True, time=True, full_state=True)
    specs = [ddp, dict(base, make_batches=ddp_batches, tpu=dict(use_pallas=True, compute_dtype="bfloat16")),
             dict(base, tpu=dict(use_pallas=True, tensor_parallel=TP_DEGREE, zero_opt=True), time=True),
             dict(base, tpu=dict(use_pallas=True, tensor_parallel=TP_DEGREE)),
             dict(base, tpu=dict(use_pallas=True, zero_opt=True)),
             dict(base, make_batches=ddp_batches, time=True, bucket_mb=float("inf"))]
    one = dryrun.run_steps(dict(ddp, init_state=True))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dryrun.spawn(dryrun.steps_on_rank, DDP_RANKS, (specs,), device="cuda", timeout=DDP_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    dp, bf16, tpz, tp, dpz, one_bucket = ([r[i] for r in ranks] for i in range(len(specs)))

    want_train = tuple(n * DDP_STEPS for n in TRAIN_LAUNCHES["float32"])
    ref_sd, init = one["state_dict"], one["state_dict_init"]
    weights = [k for k, v in ref_sd.items()
               if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))]
    err = torch.cat([(dp[0]["state_dict"][k] - ref_sd[k]).abs().flatten() for k in weights])
    param_err, max_step = err.max().item(), 2 * lr * DDP_STEPS
    flip_share = (err > DDP_FLIP_ATOL).float().mean().item()
    update_rel = {}  # each module's update (p - p0) against one process's
    for m in sorted({k.split(".")[0] for k in weights}):
        ks = [k for k in weights if k.split(".")[0] == m]
        d_one = torch.cat([(ref_sd[k] - init[k]).flatten() for k in ks])
        d_dp = torch.cat([(dp[0]["state_dict"][k] - init[k]).flatten() for k in ks])
        update_rel[m] = ((d_dp - d_one).norm() / d_one.norm().clamp_min(1e-30)).item()
    worst_gn = max(rel(r["grad_norms"][-1][k], v) for r in dp for k, v in one["grad_norms"][-1].items())
    step_ms = [float(np.mean(r["step_ms"][1:])) for r in dp]
    say("ddp", ranks=DDP_RANKS, backend="gloo", batch=BATCH, rows_per_rank=BATCH // DDP_RANKS, steps=DDP_STEPS,
        losses=",".join(f"{v:.6f}" for v in dp[0]["losses"]), losses_one_process=",".join(
            f"{v:.6f}" for v in one["losses"]),
        worst_rel_loss=f"{max(rel(a, b) for r in dp for a, b in zip(r['losses'], one['losses'])):.2e}",
        worst_gnorm_rel=f"{worst_gn:.2e}", checksum_rel=f"{rel(dp[0]['checksum'], one['checksum']):.2e}",
        param_max_abs_err=f"{param_err:.3e}", share_beyond_flip_atol=f"{flip_share:.3e}",
        worst_module_update_rel=f"{max(update_rel.values()):.3e}", module_update_rel=",".join(
            f"{k}:{v:.2e}" for k, v in update_rel.items()),
        eval_argmax_agreement=f"{float((dp[0]['preds'] == one['preds']).mean()):.4f}",
        step_ms_per_rank=",".join(f"{v:.3f}" for v in step_ms),
        step_ms_per_rank_one_bucket=",".join(f"{float(np.mean(r['step_ms'][1:])):.3f}" for r in one_bucket),
        buckets=dp[0]["buckets"], step_ms_one_process=f"{float(np.mean(one['step_ms'][1:])):.3f}",
        allreduce_ms=",".join(f"{r['allreduce_ms']:.3f}" for r in dp), allreduce_mb=f"{dp[0]['allreduce_mb']:.1f}",
        launches_per_rank=fmt_counts(dp[0]["launches_train"]), launches_eval_per_rank=fmt_counts(
            dp[0]["launches_eval"]), spawn_s=f"{spawn_s:.1f}", seconds=f"{time.perf_counter() - t_phase:.1f}")
    check(one["launches_train"] == want_train, f"one process: {one['launches_train']}, want {want_train}")
    for r in dp:
        check(r["launches_train"] == want_train, f"ddp rank {r['rank']}: {r['launches_train']}, want {want_train}")
        check(r["launches_eval"] == EVAL_LAUNCHES["float32"],
              f"ddp rank {r['rank']}: eval {r['launches_eval']}, want {EVAL_LAUNCHES['float32']}")
        check(all(np.isfinite(r["losses"])), f"ddp: non-finite losses {r['losses']}")
        for a, b in zip(r["losses"], one["losses"]):
            check(rel(a, b) <= TOL_TRAIN_LOSS, f"ddp loss {a} against one process {b}")
        gn, gn1 = r["grad_norms"][-1], one["grad_norms"][-1]
        bad = {k: rel(gn[k], gn1[k]) for k in gn1 if not rel(gn[k], gn1[k]) <= TOL_TRAIN_GNORM}
        check(not bad, f"ddp module gradient norms off one process: {bad}")
        agree = float((r["preds"] == one["preds"]).mean())
        check(agree >= MIN_ARGMAX_AGREEMENT, f"ddp validation argmax agreement {agree}")
    bad = {k: v for k, v in update_rel.items() if not v <= TOL_DDP_UPDATE}
    check(not bad, f"ddp module updates off one process's (relative, limit {TOL_DDP_UPDATE}): {bad}")
    check(flip_share <= TOL_DDP_FLIP_SHARE,
          f"ddp: {flip_share:.3e} of the parameters beyond {DDP_FLIP_ATOL} of one process's "
          f"(limit {TOL_DDP_FLIP_SHARE})")
    check(param_err <= max_step, f"ddp parameters off one process by {param_err:.3e} > {max_step:.1e}")
    check(dp[0]["checksum"] == dp[1]["checksum"], "the two ranks end with different parameters")
    check(dp[0]["buckets"] > 1 and one_bucket[0]["buckets"] == 1,
          f"ddp: the gradient went in {dp[0]['buckets']} bucket(s), {one_bucket[0]['buckets']} with no cap")
    for r, f in zip(dp, one_bucket):
        for a, b in zip(r["losses"], f["losses"]):
            check(rel(a, b) <= TOL_TRAIN_LOSS, f"ddp loss {a} (buckets) against {b} (one bucket)")

    want_bf16 = tuple(n * DDP_STEPS for n in TRAIN_LAUNCHES["bfloat16"])
    for r, r32 in zip(bf16, dp):
        check(r["launches_train"] == want_bf16, f"ddp bf16 rank {r['rank']}: {r['launches_train']}, want {want_bf16}")
        for a, b in zip(r["losses"], r32["losses"]):
            check(rel(a, b) <= TOL_BF16_TRAIN_LOSS, f"ddp bf16 loss {a} against fp32 {b}")
        bad = {k: v for k, v in r["grad_norms"][-1].items()
               if not rel(v, r32["grad_norms"][-1][k]) <= TOL_BF16_TRAIN_GNORM}
        check(not bad, f"ddp bf16 module gradient norms off the fp32 DP step: {bad}")
    say("ddp bf16", losses=",".join(f"{v:.6f}" for v in bf16[0]["losses"]),
        worst_rel_loss=f"{max(rel(a, b) for a, b in zip(bf16[0]['losses'], dp[0]['losses'])):.2e}",
        tol_loss=TOL_BF16_TRAIN_LOSS,
        worst_gnorm_rel=f"{max(rel(v, dp[0]['grad_norms'][-1][k]) for k, v in bf16[0]['grad_norms'][-1].items()):.2e}",
        tol_gnorm=TOL_BF16_TRAIN_GNORM, launches_per_rank=fmt_counts(bf16[0]["launches_train"]))

    for tag, rs in (("tp zero", tpz), ("tp", tp)):
        for r in rs:
            check(r["launches_train"] == (0,) * len(COUNTED_KERNELS), f"{tag}: launched {r['launches_train']}")
            check(not r["use_kernels"] and any("forces the plain (non-kernel) execution path" in w
                                                for w in r["warnings"]), f"{tag}: no kernel warning: {r['warnings']}")
            check(r["tp_sharded_leaf_count"] > 0, f"{tag}: no leaf sharded over the model axis")
            check(rel(r["losses"][0], dp[0]["losses"][0]) <= TOL_TRAIN_LOSS,
                  f"{tag} loss {r['losses'][0]} against the ddp step {dp[0]['losses'][0]}")
    say("tp", ranks=DDP_RANKS, mesh=f"(1, {TP_DEGREE})", zero_opt=True, loss=f"{tpz[0]['losses'][0]:.6f}",
        loss_ddp=f"{dp[0]['losses'][0]:.6f}", rel_loss=f"{rel(tpz[0]['losses'][0], dp[0]['losses'][0]):.2e}",
        tp_sharded_leaf_count=tpz[0]["tp_sharded_leaf_count"], step_ms_per_rank=",".join(
            f"{r['step_ms'][0]:.1f}" for r in tpz), launches=fmt_counts(tpz[0]["launches_train"]),
        bytes_per_rank_dp=dp[0]["state_bytes"], bytes_per_rank_dp_zero=",".join(
            str(r["state_bytes"]) for r in dpz), bytes_per_rank_tp2=",".join(str(r["state_bytes"]) for r in tp),
        bytes_per_rank_tp2_zero=",".join(str(r["state_bytes"]) for r in tpz),
        note="tp2_zero_equals_tp2:one_data_rank_on_a_(1,2)_mesh")
    return dp[0]["launches_train"], dp[0]["launches_eval"], bf16[0]["launches_train"]


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_ddp_nccl(root, raw, stores, accs, preds, first, cli_train):
    """The train CLI (``dualvgr_tpu_torch.train.train``) in a one-rank NCCL
    group, with the environment ``torchrun --nproc_per_node 1`` sets, on
    phase cli's dataset: the process group, the mesh, the host-sharded
    loader and the placed state on the way; its launches those of phase
    cli's training; the validate CLI in the same group on its best
    checkpoint against phase cli's predictions (argmax agreement >= 0.99);
    its final state saved (gathered, rank 0 writing) and restored bit for
    bit. Returns the training launches."""
    import torch.distributed as dist

    from dualvgr_tpu_torch.parallel import tp as ttp

    t0 = time.perf_counter()
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cfg_raw = copy.deepcopy(raw)
        cfg_raw.dataset.save_dir = os.path.join(root, "ddp_nccl")
        cfg_raw.tpu.profile_dir = ""
        cfg = copy.deepcopy(cfg_raw)
        cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
        cfg.alpha, cfg.beta, cfg.unit_layers = ALPHA, BETA, 1
        cfg = resolve_dataset_paths(cfg)
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            best_val, state = ttrain.train(cfg, feature_stores=stores)
        torch.cuda.synchronize()
        launches = launch_counts()
        check(dist.is_initialized() and dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "the train CLI brought up no one-rank NCCL group")
        check(state.placement is not None and state.placement.data.size == 1, "the state was not placed")
        check(launches == cli_train, f"ddp nccl training launched {launches}, phase cli {cli_train}")
        n_accs, n_preds, _, _ = cli_run_validate(cfg_raw, stores)
        agree = cli_agreement("ddp nccl vs cli", n_accs, n_preds, accs, preds, first)
        check(agree >= MIN_ARGMAX_AGREEMENT, f"ddp nccl: argmax agreement {agree} with phase cli")
        ckpt = os.path.join(root, "ckpt_nccl")
        save_checkpoint(ckpt, CLI_EPOCHS - 1, state, model_kwargs_tosave(cfg))
        vocab = load_vocab(cfg.dataset.vocab_json)
        twin = create_train_state(ttrain.build_model(cfg, vocab, "cuda"), state.optimizer, seed=1)
        restore_checkpoint(ckpt, twin)
        sd, opt, acc = ttp.full_state_dicts(state)
        (sb, ab, cb, gb, gen_b) = state_fields(twin)
        check(sd.keys() == sb.keys() and all(torch.equal(sd[k].cpu(), sb[k]) for k in sd), "restored params differ")
        aa = {(i, k): v.cpu() for i, st in opt["state"].items() for k, v in st.items()}
        check(aa.keys() == ab.keys() and all(torch.equal(aa[k], ab[k]) for k in aa), "restored Adam differs")
        check((state.step, state.updates, state.mini_step) == cb and all(
            torch.equal(x.cpu(), y) for x, y in zip(acc, gb)), "restored counts differ")
        check(torch.equal(state.generator.get_state(), gen_b), "restored generator differs")
        say("ddp nccl", backend=dist.get_backend(), world_size=dist.get_world_size(), best_val=f"{best_val:.4f}",
            test_acc=f"{n_accs[0]:.4f}", cli_test_acc=f"{accs[0]:.4f}", argmax_agreement_with_cli=f"{agree:.4f}",
            restore_bit_exact=True, launches_train=fmt_counts(launches), seconds=f"{time.perf_counter() - t0:.1f}")
        del state, twin
        return launches
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.cuda.empty_cache()


def phase_zoo():
    """Phase ``zoo``: every class of the zoos (decoder and question-encoder
    variants, graph, attention and model-utils zoos, fusions) once on CUDA
    tensors at a small width against the same module on the CPU, with no
    CPU tensor made on the way (``bench/zoo_check.py``)."""
    t0 = time.perf_counter()
    errs = check_zoo("cuda")
    worst = max(errs, key=errs.get)
    say("zoo", cases=len(errs), max_rel_err=f"{errs[worst]:.3e}", worst=worst, tol=TOL_ZOO,
        seconds=f"{time.perf_counter() - t0:.2f}")


# phase extract: 4 videos x 16 clips x 16 frames, and their 64 clips;
# the CPU reference on the first 8 frames and 4 clips
EXTRACT_VIDEOS = 4
EXTRACT_FRAMES, EXTRACT_CLIPS = EXTRACT_VIDEOS * CLIPS * FRAMES, EXTRACT_VIDEOS * CLIPS
EXTRACT_CPU_FRAMES, EXTRACT_CPU_CLIPS = 8, 4
#   fp32 features on the card (TF32 off) against the port's CPU fp32: only
#   the conv sum order differs -> 1e-4 x max|ref|
#   bf16 against fp32: the JAX package's own limits
#   (tests/test_preprocess_e2e.py:180-185)
TOL_EXTRACT = 1e-4
BF16_FEAT_REL_NORM, BF16_FEAT_COS = 0.02, 0.995
#   one grouped conv, grouped against block-diagonal: fp32 sums in another
#   order -> 1e-4 x max|ref|; bf16 outputs of such sums may round one bf16
#   step apart -> 2^-8 x max|ref|
TOL_GROUPED_AB = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
# phase predict: 8 videos of 96 decoded 240 x 320 frames, one question each
PREDICT_VIDEOS, PREDICT_FRAMES, PREDICT_HW = 8, 96, (240, 320)


def feature_agreement(got, ref):
    """(relative norm error, the least per-row cosine) of ``got`` against
    ``ref`` (rows of features)."""
    got, ref = got.double(), ref.double()
    rel = ((got - ref).norm() / ref.norm()).item()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
    return rel, cos


def phase_extract():
    """Phases ``extract`` and ``extract bf16``: ResNet-101 at 224^2 on 1024
    frames and ResNeXt-101 3D on 64 clips of 16 x 112^2 (seeded weights and
    pixels): ms, frames/s, clips/s, videos/s, the analytic GFLOP per frame
    and clip, TFLOP/s and the bound at the dtype's peak; fp32 on the card
    against the CPU on the first frames and clips, bf16 against fp32; each
    grouped conv shape grouped and block-diagonal. Returns the fp32
    extractors."""
    frames, clips = extraction_bench.seeded_inputs(EXTRACT_FRAMES, EXTRACT_CLIPS, seed=9)
    t_phase = time.perf_counter()
    ref_a = build_appearance_extractor(device="cpu")(frames[:EXTRACT_CPU_FRAMES].cpu())
    ref_m = build_motion_extractor(device="cpu")(clips[:EXTRACT_CPU_CLIPS].cpu())
    cpu_s = time.perf_counter() - t_phase
    fp32 = None
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        tag = "extract" if dt == "float32" else "extract bf16"
        app_x, mot_x = build_appearance_extractor(compute_dtype=dt), build_motion_extractor(compute_dtype=dt)
        feats = app_x(frames), mot_x(clips)
        torch.cuda.synchronize()
        for f, n in zip(feats, (EXTRACT_FRAMES, EXTRACT_CLIPS)):
            check(f.dtype == torch.float32 and tuple(f.shape) == (n, 2048), f"{tag}: features {f.dtype} {f.shape}")
            check(torch.isfinite(f).all().item(), f"{tag}: non-finite features")
        extra = {}
        if dt == "float32":
            fp32 = (app_x, mot_x), feats
            for name, got, ref in (("app", feats[0][:EXTRACT_CPU_FRAMES], ref_a),
                                   ("mot", feats[1][:EXTRACT_CPU_CLIPS], ref_m)):
                err = (got.cpu() - ref).abs().max().item() / ref.abs().max().item()
                check(err <= TOL_EXTRACT, f"{tag}: {name} features on the card against the CPU: {err:.3e} of max|ref|")
                extra[f"{name}_rel_err_vs_cpu"] = f"{err:.3e}"
            extra["cpu_reference_s"] = f"{cpu_s:.2f}"
        else:
            for name, got, ref in (("app", feats[0], fp32[1][0]), ("mot", feats[1], fp32[1][1])):
                rel, cos = feature_agreement(got, ref)
                check(rel < BF16_FEAT_REL_NORM and cos > BF16_FEAT_COS,
                      f"{tag}: {name} against fp32: relative norm error {rel:.4f}, least cosine {cos:.5f}")
                extra[f"{name}_rel_norm_vs_fp32"], extra[f"{name}_min_cos_vs_fp32"] = f"{rel:.2e}", f"{cos:.6f}"
        del feats
        r = extraction_bench.measure(dt, frames, clips, iters=3, app_extract=app_x, mot_extract=mot_x)
        ab = extraction_bench.grouped_ab(dt, EXTRACT_CLIPS)
        say(tag, frames=EXTRACT_FRAMES, clips=EXTRACT_CLIPS, seconds=f"{time.perf_counter() - t0:.1f}",
            app_ms=f"{r['app_ms']:.3f}", frames_per_s=f"{r['frames_per_s']:.1f}",
            app_tflop_per_s=f"{r['app_tflop_per_s']:.2f}", app_bound_ms=f"{r['app_bound_ms']:.3f}",
            app_gflop_per_frame=f"{r['app_gflop_per_frame']:.4f}",
            mot_ms=f"{r['mot_ms']:.3f}", clips_per_s=f"{r['clips_per_s']:.1f}",
            mot_tflop_per_s=f"{r['mot_tflop_per_s']:.2f}", mot_bound_ms=f"{r['mot_bound_ms']:.3f}",
            mot_gflop_per_clip=f"{r['mot_gflop_per_clip']:.4f}",
            videos_per_s_appearance=f"{r['videos_per_s_appearance']:.2f}",
            videos_per_s_motion=f"{r['videos_per_s_motion']:.2f}", videos_per_s=f"{r['videos_per_s']:.2f}",
            **extra)
        for row in ab:
            check(row["rel_err"] <= TOL_GROUPED_AB[dt], f"{tag}: block-diagonal conv differs: {row}")
            print(f"  grouped_ab C={row['channels']} stride={row['stride']} input={row['input']}: grouped "
                  f"{'/'.join(f'{x:.3f}' for x in row['grouped_ms'])} ms, blockdiag "
                  f"{'/'.join(f'{x:.3f}' for x in row['blockdiag_ms'])} ms, faster {row['faster']}, "
                  f"rel_err {row['rel_err']:.2e}", flush=True)
        del app_x, mot_x
        torch.cuda.empty_cache()
    return fp32[0]


def phase_predict(raw, extractors):
    """Phase ``predict``: 8 videos of seeded uint8 frames (96 of 240 x 320
    each) and one question each through ``predict.predict_frames`` (the
    clips resized on the card, both fp32 backbones, one DualVGR forward)
    with the flagship GAT model restored from phase cli's checkpoint: the
    launches of that run (kernel 1 three times and kernel 2 twice), the
    logits against the plain path on the same features, the top 5, and
    each stage's ms (resize, appearance, motion, DualVGR) and the whole
    per video."""
    t_phase = time.perf_counter()
    cfg = copy.deepcopy(raw)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    model, vocab = model_from_checkpoint(cfg, 1)
    app_x, mot_x = extractors
    rng = np.random.RandomState(11)
    videos = [rng.randint(0, 256, (PREDICT_FRAMES, *PREDICT_HW, 3), dtype=np.uint8) for _ in range(PREDICT_VIDEOS)]
    questions = [f"{BUCKET_WORDS[i % len(BUCKET_WORDS)]} is word{100 + 7 * i} doing with word{200 + i}?"
                 for i in range(PREDICT_VIDEOS)]
    kw = dict(model=model, vocab=vocab, app_extract=app_x, mot_extract=mot_x, num_clips=CLIPS, device="cuda")
    tpredict.predict_frames(videos[:1], questions[:1], **kw)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = tpredict.predict_frames(videos, questions, **kw)
    torch.cuda.synchronize()
    whole_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    check(launches == EVAL_LAUNCHES["float32"], f"predict launched {launches}, want {EVAL_LAUNCHES['float32']} "
                                                f"(one DualVGR forward)")
    check(tuple(logits.shape) == (PREDICT_VIDEOS, FLAGSHIP["num_answers"]) and torch.isfinite(logits).all().item(),
          f"predict logits {tuple(logits.shape)}")

    feats = [tpredict.video_features(v, app_x, mot_x, CLIPS) for v in videos]
    app, mot = torch.stack([a for a, _ in feats]), torch.stack([m for _, m in feats])
    q, qlen = tpredict.encode_questions(questions, vocab)
    model.use_kernels = False
    ref = tpredict.answer_logits(model, app, mot, q, qlen)
    model.use_kernels = True
    scale = ref.abs().max().item()
    err = max_err(logits, ref)
    check(err <= TOL_LOGITS * scale, f"predict logits against the plain path: {err:.3e} > {TOL_LOGITS} * {scale:.3e}")
    check(torch.equal(logits.argmax(-1), ref.argmax(-1)), "predict: an argmax differs from the plain path's")
    top = tpredict.top_answers(logits.cpu().numpy(), vocab["answer_idx_to_token"], TOP_K)

    v0 = videos[0]

    def resize():
        on_card = torch.as_tensor(v0).cuda()  # the uint8 frames' copy, as video_features makes it
        return (clips_from_frames(on_card, CLIPS, FRAMES, (224, 224), False),
                clips_from_frames(on_card, CLIPS, FRAMES, (112, 112), True))

    resize_ms = time_ms(resize, 3)
    clips_a = clips_from_frames(v0, CLIPS, FRAMES, (224, 224), False).reshape(CLIPS * FRAMES, 3, 224, 224)
    clips_m = clips_from_frames(v0, CLIPS, FRAMES, (112, 112), True)
    app_ms = time_ms(lambda: app_x(clips_a), 3)
    mot_ms = time_ms(lambda: mot_x(clips_m), 3)
    dualvgr_ms = time_ms(lambda: tpredict.answer_logits(model, app, mot, q, qlen), 5)
    say("predict", videos=PREDICT_VIDEOS, frames_per_video=PREDICT_FRAMES, frame_hw="x".join(map(str, PREDICT_HW)),
        seconds=f"{time.perf_counter() - t_phase:.1f}",
        launches_per_forward=f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]}",
        logits_max_abs_err=f"{err:.3e}", max_abs_logit=f"{scale:.3e}", argmax_equal=True,
        resize_ms=f"{resize_ms:.3f}", appearance_ms=f"{app_ms:.3f}", motion_ms=f"{mot_ms:.3f}",
        dualvgr_ms=f"{dualvgr_ms:.3f}", per_video_ms=f"{whole_ms / PREDICT_VIDEOS:.3f}",
        whole_ms=f"{whole_ms:.3f}", video0_top5=",".join(f"{a}:{p:.4f}" for a, p in top[0]))
    del model
    torch.cuda.empty_cache()
    return launches


def kernel_entry(name, source, replaces, launches, cases, per, library, side_cases=(), peak=PEAK_FP32_FLOPS,
                 **extra):
    """One row of the kernels line: the sums over the cases of one step or
    forward; ``side_cases`` (the bf16-gate variants on the bf16 paths,
    kernel 2 at the serving batch) are listed beside them in ``shapes`` and
    in the error, not in the sums."""
    total = lambda key: sum(c[key] for c in cases)
    bms, by = bound_ms(total("flops"), total("bytes"), peak)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") if library else ("ms", "plain_ms", "bound_ms")
    shapes = {c["shape"]: {k: c[k] for k in keys} for c in cases}
    shapes.update({c["shape"]: {k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms") if c.get(k) is not None}
                   for c in side_cases})
    # kernels 1-4: each shape's launch plan
    for c in (*cases, *side_cases):
        if "plan" in c:
            shapes[c["shape"]]["plan"] = c["plan"]
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max(c["err"] for c in (*cases, *side_cases)), ms=total("ms"),
                plain_ms=total("plain_ms"), bound_ms=bms, bound_by=by,
                library_ms=total("library_ms") if library else None, per=per, shapes=shapes, **extra)


def main():
    phase_device()
    phase_build()
    model = build_model(seed=0, **FLAGSHIP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    app, mot, q, qlen = flagship_inputs(BATCH, gen)
    lstm_cases = phase_bilstm(model, app, q, qlen)
    gat_cases, gat_serve_cases = phase_gat(model, app, mot, q, qlen)
    model_ms = {}
    model_ms["eval"], fp32_logits, _ = phase_eval(model, app, mot, q, qlen)
    lstm_bf16, fwd_bf16, bwd_bf16 = phase_bilstm_bf16(model, app, q, qlen,
                                                     torch.Generator(device="cuda").manual_seed(4))
    model_ms["eval bf16"], _ = phase_eval_bf16(model, app, mot, q, qlen, fp32_logits)
    model.compute_dtype = "float32"
    del fp32_logits
    gcn_ms, gcn = phase_gcn(app, mot, q, qlen)
    model_ms.update(gcn_ms)
    del app, mot
    torch.cuda.empty_cache()
    serve_launches = phase_serve(model)
    model.compute_dtype = "bfloat16"
    serve_bf16_launches = phase_serve(model, tag="serve bf16")
    model.compute_dtype = "float32"
    phase_serve_breakdown(model)
    export_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_export_")
    export_launches, export_path = phase_export(model, export_dir.name)
    model.compute_dtype = "bfloat16"
    export_bf16_launches, _ = phase_export(model, export_dir.name, tag="export bf16")
    model.compute_dtype = "float32"

    batch = train_batch(torch.Generator(device="cuda").manual_seed(1))
    fwd_cases, bwd_cases = phase_bilstm_train(model, batch[0], batch[2], batch[3])
    del model
    torch.cuda.empty_cache()
    train_launches, model_ms["train"] = phase_train(batch)
    torch.cuda.empty_cache()
    train_bf16_launches, _ = phase_train(batch, "bfloat16")
    torch.cuda.empty_cache()
    gcn["gcn train"], model_ms["gcn train"] = phase_train(batch, graph_module="GCN")
    torch.cuda.empty_cache()
    gcn["batch_gats eval"] = phase_batch_gats(batch)
    del batch
    torch.cuda.empty_cache()
    phase_nccl_two_ranks()
    ddp_launches, ddp_eval_launches, ddp_bf16_launches = phase_ddp()
    torch.cuda.empty_cache()
    k5_cases, k6_cases, tanh_cases, n5 = phase_proj()
    torch.cuda.empty_cache()
    k7_cases = phase_proj_f32()
    k8_cases = phase_wgrad_f32()
    k9_cases = phase_whh_grad_f32()
    extractors = phase_extract()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        raw, stores, cli_train, cli_val, accs, preds, first = phase_cli(root, model_ms)
        ddp_nccl_launches = phase_ddp_nccl(root, raw, stores["float32"], accs, preds, first, cli_train)
        cli_bf16 = phase_cli_bf16(raw, stores, accs, preds, first, model_ms)
        predict_launches = phase_predict(raw, extractors)
        del extractors
        http_launches = phase_http(root, raw, stores["float32"], preds, export_path)
        gcn["gcn cli train"], gcn["gcn cli validate"], gcn["gcn serve"] = phase_gcn_cli(root, stores["float32"])
        del stores
    export_dir.cleanup()
    phase_zoo()

    # kernel 1 once at each of its three shapes per flagship forward, kernel
    # 2 once per stream; kernels 3 and 4 once at each of the three shapes
    # per train step. Each row sums its cases' measurements over one fp32
    # forward or step; the bf16-gate shapes are listed beside them. Kernels
    # 5 and 6 are rows per call at R = 4096 (batch 256), R = 512 (batch 32)
    # listed beside it, bound at the bf16 tensor-core peak; kernel 7 a row
    # per call at msrvtt-qa's train step, the other cells beside it, bound
    # at the TF32 tensor-core peak (three products); kernels 8 and 9 likewise.
    eval_shapes = "appearance + question_outputs + question_final"

    def cli_launches(i):
        """Kernel i's launches in phases cli (train and validate CLIs)
        and cli bf16 (the validate CLI)."""
        return dict(launches_cli_train=cli_train[i], launches_cli_validate=cli_val[i],
                    launches_cli_bf16_validate=cli_bf16[i])

    def gcn_launches(i):
        """Kernel i's launches in the GCN phases: one forward (phases gcn,
        gcn bf16), the 5 timed steps of gcn train, the gcn cli's train and
        validate runs and its 64 served requests; and the batch_gats model's
        kernel eval forward."""
        return {f"launches_{k.replace(' ', '_')}": n[i] for k, n in gcn.items()}

    def ddp_launches_of(i):
        """Kernel i's launches in the multi-device phases: on each rank of
        phase ddp over its 3 steps and its validation forward, in its bf16
        step, and in phase ddp nccl's training."""
        return dict(launches_ddp=ddp_launches[i], launches_ddp_eval=ddp_eval_launches[i],
                    launches_ddp_bf16=ddp_bf16_launches[i], launches_ddp_nccl=ddp_nccl_launches[i])

    def deploy_launches(i):
        """Kernel i's launches through the loaded artifacts (phases export,
        export bf16) and the HTTP front (phase http, its three routes)."""
        return dict(launches_export=export_launches[i], launches_export_bf16=export_bf16_launches[i],
                    launches_http=http_launches[i])

    kernels = [
        kernel_entry("bilstm_recurrence", "dualvgr_tpu_torch/csrc/bilstm_recurrence.cu",
                     "dualvgr_tpu/ops/lstm_pallas.py:107", serve_launches[0], lstm_cases,
                     f"one flagship forward (batch 256): {eval_shapes}; *_bf16: the bf16 forward's "
                     "bf16-gate shapes", **ddp_launches_of(0), library=True, side_cases=lstm_bf16,
                     launches_bf16=serve_bf16_launches[0], **cli_launches(0), **deploy_launches(0),
                     **gcn_launches(0), launches_predict=predict_launches[0]),
        kernel_entry("gat_cycle", "dualvgr_tpu_torch/csrc/gat_cycle.cu",
                     "dualvgr_tpu/ops/gat_pallas.py:105", serve_launches[1], gat_cases,
                     "one flagship forward (batch 256): appearance + motion streams (fp32 in the bf16 "
                     f"forward too); *_b{SERVE_BATCH}: the same streams' first {SERVE_BATCH} videos (a served "
                     "batch)", **ddp_launches_of(1), library=False, side_cases=gat_serve_cases,
                     launches_bf16=serve_bf16_launches[1],
                     **cli_launches(1), **deploy_launches(1), **gcn_launches(1),
                     launches_predict=predict_launches[1]),
        kernel_entry("bilstm_train_fwd", "dualvgr_tpu_torch/csrc/bilstm_train_fwd.cu",
                     "dualvgr_tpu/ops/lstm_pallas_train.py:202", train_launches[2], fwd_cases,
                     f"one flagship train step (batch 256): {eval_shapes}; library: cuDNN "
                     "training-mode forward, input projection included; appearance_bf16: the bf16 "
                     "step's bf16 gates", **ddp_launches_of(2), library=True, side_cases=[fwd_bf16],
                     launches_bf16=train_bf16_launches[2], **cli_launches(2), **gcn_launches(2)),
        kernel_entry("bilstm_train_bwd", "dualvgr_tpu_torch/csrc/bilstm_train_bwd.cu",
                     "dualvgr_tpu/ops/lstm_pallas_train.py:239", train_launches[3], bwd_cases,
                     f"one flagship train step (batch 256): {eval_shapes}; library: cuDNN backward, "
                     "dX, dW_ih, dW_hh and the biases' gradients included; appearance_bf16: the bf16 "
                     "step's bf16 gates", **ddp_launches_of(3), library=True, side_cases=[bwd_bf16],
                     launches_bf16=train_bf16_launches[3], **cli_launches(3), **gcn_launches(3)),
        kernel_entry("input_proj_one", "dualvgr_tpu_torch/csrc/input_proj.cu",
                     "benchmarks/proj_probe.py:68", n5, k5_cases[:1],
                     "two launches (forward, time-reversed) at R = 4096, as the probe's v2; R512 at batch "
                     "32; library: the probe's v0 (tanh, two cuBLAS bf16 products with fp32 output, bias, "
                     "cast, time-major copy, flip)", **ddp_launches_of(4), library=True, side_cases=k5_cases[1:],
                     peak=PEAK_BF16_FLOPS),
        kernel_entry("input_proj_both", "dualvgr_tpu_torch/csrc/input_proj.cu",
                     "benchmarks/proj_probe.py:112", serve_bf16_launches[5], k6_cases[:1],
                     "one call on fp32 x (the tanh pass, then the product) at R = 4096 (the bf16 forward at "
                     "batch 256); R512 at batch 32; library: the probe's v0 (library_v1_ms: v1); bf16_x_ms: "
                     "the form on bf16 x (the bf16 train step's); tanh_to_bf16: the tanh pass alone",
                     **ddp_launches_of(5), library=True, side_cases=k6_cases[1:], peak=PEAK_BF16_FLOPS,
                     launches_train_bf16=train_bf16_launches[5], **cli_launches(5), **deploy_launches(5),
                     **gcn_launches(5),
                     library_v1_ms=k6_cases[0]["library_v1_ms"],
                     bf16_x_ms=k6_cases[0]["bf16_x_ms"], bf16_x_bound_ms=k6_cases[0]["bf16_x_bound_ms"],
                     tanh_to_bf16=dict(
                         source="dualvgr_tpu_torch/csrc/input_proj.cu", replaces="benchmarks/proj_probe.py:124",
                         launches=serve_bf16_launches[6], **cli_launches(6), **deploy_launches(6),
                         **gcn_launches(6), **ddp_launches_of(6),
                         max_abs_err=tanh_cases[0]["err"],
                         **{k: tanh_cases[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                         per="one call on the R = 4096 x; library: torch.tanh(x, out=bf16); R512 at batch 32",
                         shapes={c["shape"]: {k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
                                 for c in tanh_cases})),
        kernel_entry("input_proj_f32", "dualvgr_tpu_torch/csrc/input_proj_f32.cu",
                     "none: the fp32 projection the JAX package leaves to XLA (dualvgr_tpu/ops/lstm.py:96)",
                     train_launches[7], k7_cases[:1],
                     "one call at msrvtt-qa's train step (R*T = 65,536), the other cells beside; bound: the "
                     "three products at 495 TFLOP/s TF32; plain: the two torch.baddbmm products, bias "
                     "broadcast and flip it replaces; library: one torch.baddbmm over both directions' "
                     "columns; launches: phase train's 5 fp32 steps", library=True, side_cases=k7_cases[1:],
                     peak=PEAK_TF32_FLOPS, launches_eval=serve_launches[7], **ddp_launches_of(7),
                     **cli_launches(7), **deploy_launches(7), **gcn_launches(7),
                     launches_predict=predict_launches[7],
                     rel_err={c["shape"]: c["rel_err"] for c in k7_cases}),
        kernel_entry("input_proj_f32_wgrad", "dualvgr_tpu_torch/csrc/wgrad_f32.cu",
                     "none: the appearance projection's dW_ih, which the JAX package leaves to XLA "
                     "(dualvgr_tpu/ops/lstm_pallas_train.py:440)",
                     train_launches[8], k8_cases[:1],
                     "one call at msrvtt-qa's train step (R*T = 65,536), the other cells beside; bound: the "
                     "three products at 495 TFLOP/s TF32; plain and library: the two SGEMMs after the "
                     "transposing copies it replaces; launches: phase train's 5 fp32 steps", library=True,
                     side_cases=k8_cases[1:], peak=PEAK_TF32_FLOPS, **ddp_launches_of(8), **cli_launches(8),
                     **gcn_launches(8), rel_err={c["shape"]: c["rel_err"] for c in k8_cases}),
        kernel_entry("whh_grad_f32", "dualvgr_tpu_torch/csrc/whh_grad_f32.cu",
                     "none: the trainable BiLSTM's dW_hh, which the JAX package leaves to XLA "
                     "(dualvgr_tpu/ops/lstm_pallas_train.py:274-277)",
                     train_launches[9], k9_cases[:1],
                     "one call at msrvtt-qa's appearance BiLSTM (R*T = 65,536, H 384), the other cells and a "
                     "question BiLSTM (256 x 24) beside; bound: the three products at 495 TFLOP/s TF32; plain "
                     "and library: the two SGEMMs it replaces; launches: phase train's 5 fp32 steps (3 a step: "
                     "the appearance and both question BiLSTMs)", library=True, side_cases=k9_cases[1:],
                     peak=PEAK_TF32_FLOPS, launches_train_bf16=train_bf16_launches[9],
                     launches_serve=serve_launches[9], launches_serve_bf16=serve_bf16_launches[9],
                     **ddp_launches_of(9), **cli_launches(9), **deploy_launches(9), **gcn_launches(9),
                     launches_predict=predict_launches[9], rel_err={c["shape"]: c["rel_err"] for c in k9_cases}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
