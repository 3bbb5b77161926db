#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``dualvgr_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA device (an H100 is the target) and ``nvcc``. Phases, one
line each:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: both kernels from dualvgr_tpu_torch/csrc with nvcc for sm_90a;
3. the BiLSTM recurrence kernel against its plain version at the three
   shapes of the flagship forward, with bidirectional torch.nn.LSTM (cuDNN,
   projection included) timed as the library yardstick;
4. the graph-cycle kernel against its plain version on the appearance and
   the motion stream's inputs, B=256, N=16, D=768;
5. the eval forward at the MSRVTT-QA flagship width, batch 256, kernel path
   against plain path, launch counts per forward, QA/s;
6. serving: a BatchingEngine(max_batch=32) around build_predict_fn answers
   64 concurrent requests at full width; this is the serving path, whose
   launches of kernels 1 and 2 are counted;
7. bilstm_train: the trainable recurrence's forward and backward kernels
   (kernels 3 and 4) against their plain versions at the three shapes of
   the flagship train step, with bidirectional torch.nn.LSTM (cuDNN) in
   training mode timed as the yardstick: its forward for kernel 3, its
   backward for kernel 4;
8. train: the train step at the flagship width, batch 256 with the last 6
   rows padded: after 2 warm-up steps, one step's loss and per-module
   gradient norms, kernel path against plain path with dropout off; then
   5 timed steps with dropout on (ms per step, QA/s, losses, peak memory),
   the training path whose launches of kernels 3 and 4 are counted (3 each
   per step, none of kernels 1 and 2); one step under the profiler.

Then one JSON line with the kernel table and, last, the device line. Any
failed check raises, and the script exits nonzero. Weights come from the
port's own seeded init. Everything runs in fp32: TF32 is switched off for
matmuls and for cuDNN, so the plain versions and the yardstick are fp32.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from dualvgr_tpu_torch import (
    BatchingEngine, build_model, build_predict_fn, create_train_state, make_optimizer, train_step,
)
from dualvgr_tpu_torch.config import cfg_from_file
from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.dropout import Dropout
from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle, gat_cycle_reference
from dualvgr_tpu_torch.ops.lstm import time_major_input_proj
from dualvgr_tpu_torch.ops.lstm_kernel import bilstm_recurrence, bilstm_recurrence_reference
from dualvgr_tpu_torch.ops.lstm_train_kernel import (
    bilstm_train_bwd, bilstm_train_bwd_reference, bilstm_train_fwd, bilstm_train_fwd_reference,
)
from dualvgr_tpu_torch.train_lib import forward_backward

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
# H100 SXM published peaks: fp32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
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


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up
    call, with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_err(a, b):
    return (a - b).abs().max().item()


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
    say("build", seconds=f"{secs:.2f}", compiled=sorted(reports))
    for src, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {src}: {line.strip()}", flush=True)


def flagship_inputs(batch, gen):
    dev = gen.device
    app = torch.randn((batch, CLIPS, FRAMES, FLAGSHIP["vision_dim"]), generator=gen, device=dev)
    mot = torch.randn((batch, CLIPS, FLAGSHIP["vision_dim"]), generator=gen, device=dev)
    qlen = torch.randint(4, QLEN + 1, (batch,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randint(1, FLAGSHIP["question_vocab_size"], (batch, QLEN), generator=gen, device=dev,
                      dtype=torch.int32)
    q = q * (torch.arange(QLEN, device=dev)[None, :] < qlen[:, None])
    return app, mot, q.to(torch.int32), qlen


def lstm_case(name, enc, x, lengths, with_outputs):
    """Kernel vs plain recurrence on the projections of one BiLSTM of the
    model, plus torch.nn.LSTM on the same rows as the yardstick."""
    fwd, bwd = enc._params(""), enc._params("_reverse")
    xf = time_major_input_proj(x, fwd)
    xb = time_major_input_proj(x, bwd, reverse=True)
    whf, whb = fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous()
    args = (xf, xb, whf, whb, lengths)
    got = bilstm_recurrence(*args, with_outputs=with_outputs)
    torch.cuda.synchronize()
    want = bilstm_recurrence_reference(*args, with_outputs=with_outputs)
    got, want = (got, want) if with_outputs else ((got,), (want,))
    errs = [max_err(g, w) for g, w in zip(got, want)]
    check(all(torch.isfinite(g).all().item() for g in got), f"{name}: non-finite kernel output")
    check(max(errs) <= TOL_LSTM, f"{name}: kernel vs plain max abs err {errs} > {TOL_LSTM}")

    ms = time_ms(lambda: bilstm_recurrence(*args, with_outputs=with_outputs), 10)
    plain_ms = time_ms(lambda: bilstm_recurrence_reference(*args, with_outputs=with_outputs), 3)

    t_total, r, g = xf.shape
    h = g // 4
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

    # what these inputs need: a padded step leaves the state as it was, so
    # each direction runs len_r steps of row r, each an (H) @ (H, 4H)
    # product reading that step's 4H gates
    steps = t_total * r if lengths is None else int(lengths.sum().item())
    flops = 2 * steps * 2 * h * g
    nbytes = 4 * (2 * steps * g + 2 * whf.numel() + r * 2 * h)
    if lengths is not None:
        nbytes += 4 * r
    if with_outputs:
        nbytes += 4 * r * t_total * 2 * h
    bms, by = bound_ms(flops, nbytes)
    say(f"bilstm {name}", T=t_total, R=r, H=h, masked=lengths is not None, outputs=with_outputs,
        max_abs_err=f"{max(errs):.3e}", tol=TOL_LSTM, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)
    return dict(shape=name, err=max(errs), ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bms, flops=flops, bytes=nbytes)


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
    flops = 8 * b * n * d * d + 4 * b * n * n * d + 8 * b * n * d
    score_bytes = 4 * b * n  # the broadcast view holds one float per clip
    nbytes = 4 * (h.numel() + 3 * d * d + 4 * d + 4 * heads * (d // heads) + 2 * heads) \
        + score_bytes + 4 * 3 * h.numel()
    bms, by = bound_ms(flops, nbytes)
    say(f"gat_cycle {name}", B=b, N=n, D=d, heads=heads, err_out=f"{errs[0]:.3e}",
        err_common=f"{errs[1]:.3e}", err_spec=f"{errs[2]:.3e}", tol=f"{TOL_GAT}*max(1,max|ref|)",
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bms:.4f}", bound_by=by)
    return dict(shape=name, err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bms, flops=flops,
                bytes=nbytes)


@torch.no_grad()
def phase_gat(model, app, mot, q, qlen):
    """The cycle on both streams' real inputs at batch 256, as one flagship
    forward launches it."""
    _, words, dynamic = model.linguistic_input_unit(q, qlen, use_kernel=False)
    h_app = model.visual_appearance_input_unit(app, use_kernel=False)
    h_mot = model.visual_motion_input_unit(mot)
    vu = model.visual_input_unit
    guided, _ = vu.queryAttn[0](words, dynamic, qlen)
    # the scores are broadcast views, one score per clip
    return [
        gat_case("appearance", h_app, vu.queryPunish_appear[0](guided, h_app),
                 (*vu.acGCN[0].merged(), *vu.appearance_GCN[0].merged(),
                  *vu.attention_appearance[0].merged())),
        gat_case("motion", h_mot, vu.queryPunish_motion[0](guided, h_mot),
                 (*vu.mcGCN[0].merged(), *vu.motion_GCN[0].merged(), *vu.attention_motion[0].merged())),
    ]


KERNELS = (bilstm_recurrence, gat_cycle, bilstm_train_fwd, bilstm_train_bwd)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts():
    """Launches of kernels 1-4; the eval path's are the first two."""
    return tuple(k.launches for k in KERNELS)


@torch.no_grad()
def phase_eval(model, app, mot, q, qlen):
    model.use_kernels = True
    reset_counts()
    out = model(app, mot, q, qlen)
    torch.cuda.synchronize()
    n_lstm, n_gat = counts()[:2]
    check((n_lstm, n_gat) == (3, 2), f"one forward launched ({n_lstm}, {n_gat}) kernels, want (3, 2)")
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
    say("eval", batch=BATCH, logits_max_abs_err=f"{err:.3e}", max_abs_logit=f"{scale:.3e}",
        argmax_agreement=f"{agree:.4f}", aux_max_abs_err=f"{max(aux.values()):.3e}",
        launches_per_forward=f"bilstm_recurrence:{n_lstm},gat_cycle:{n_gat}",
        forward_ms=f"{ms:.3f}", qa_per_s=f"{BATCH / ms * 1e3:.1f}",
        plain_forward_ms=f"{plain_ms:.3f}", plain_qa_per_s=f"{BATCH / plain_ms * 1e3:.1f}")
    profile_run("profile", lambda: model(app, mot, q, qlen))
    return ms


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


def phase_serve(model):
    """The main path: concurrent requests through the engine."""
    rng = np.random.RandomState(1)
    vd = FLAGSHIP["vision_dim"]
    reqs = [
        (rng.randn(CLIPS, FRAMES, vd).astype(np.float32), rng.randn(CLIPS, vd).astype(np.float32),
         rng.randint(1, FLAGSHIP["question_vocab_size"], (4 + i % (QLEN - 3),)).astype(np.int32))
        for i in range(SERVE_REQUESTS)
    ]
    predict = build_predict_fn(model, TOP_K)

    # the same requests straight through predict, in batches of the engine's
    # size: the answers to hold the engine's against (and the warm-up)
    direct = []
    for s in range(0, SERVE_REQUESTS, SERVE_BATCH):
        chunk = reqs[s : s + SERVE_BATCH]
        q = np.zeros((len(chunk), QLEN), np.int32)
        for i, r in enumerate(chunk):
            q[i, : len(r[2])] = r[2]
        ids, scores = predict(np.stack([r[0] for r in chunk]), np.stack([r[1] for r in chunk]), q,
                              np.array([len(r[2]) for r in chunk], np.int32))
        direct += list(zip(ids, scores))
    torch.cuda.synchronize()

    results = [None] * SERVE_REQUESTS
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
        threads = [threading.Thread(target=call, args=(i,)) for i in range(SERVE_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()[:2]
        stats = eng.stats()
    check(not errors, f"serve errors: {errors[:3]}")
    check(all(r is not None for r in results), "a request got no answer")
    check(stats["requests"] == SERVE_REQUESTS, f"engine counted {stats['requests']} requests")
    check(launches == (3 * stats["batches"], 2 * stats["batches"]),
          f"serve launched {launches} kernels over {stats['batches']} batches, want 3 and 2 per batch")
    for i, ((got_ids, got_scores), (ids, scores)) in enumerate(zip(results, direct)):
        check(got_ids.shape == (TOP_K,) and np.isfinite(got_scores).all(), f"request {i}: bad answer")
        check(np.allclose(got_scores, scores, atol=1e-6), f"request {i}: scores differ from direct")
        # the top-1 id may differ only where the top two scores tie
        check(got_ids[0] == ids[0] or scores[0] - scores[1] <= 1e-6, f"request {i}: other top-1")
    say("serve", requests=stats["requests"], batches=stats["batches"],
        mean_batch=f"{stats['mean_batch']:.2f}", p50_ms=f"{stats['latency_ms_p50']:.2f}",
        p99_ms=f"{stats['latency_ms_p99']:.2f}", qa_per_s=f"{SERVE_REQUESTS / wall:.1f}",
        launches=f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]}")
    return launches


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


def train_lstm_case(name, enc, x, lengths, with_outputs, gen):
    """Kernels 3 and 4 against their plain versions on the projections of
    one BiLSTM of the model, timed beside cuDNN's training forward and
    backward, with the bound of each from this case's shapes and lengths."""
    fwd, bwd = enc._params(""), enc._params("_reverse")
    xf = time_major_input_proj(x, fwd)
    xb = time_major_input_proj(x, bwd, reverse=True)
    whf, whb = fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous()
    t_total, r, g = xf.shape
    h = g // 4
    fargs = (xf, xb, whf, whb, lengths)

    got = bilstm_train_fwd(*fargs, with_outputs=with_outputs)
    torch.cuda.synchronize()
    want = bilstm_train_fwd_reference(*fargs, with_outputs=with_outputs)
    fwd_err = 0.0
    for field, a, b in zip(("final", "outs", "hprev", "cprev"), got, want):
        if b is None:
            continue
        check(torch.isfinite(a).all().item(), f"train fwd {name} {field}: non-finite kernel output")
        fwd_err = max(fwd_err, max_err(a, b))
    check(fwd_err <= TOL_LSTM, f"train fwd {name}: kernel vs plain max abs err {fwd_err:.3e} > {TOL_LSTM}")
    _, _, hprev, cprev = want
    del got, want

    dfinal = torch.randn((r, 2 * h), generator=gen, device=x.device)
    douts = torch.randn((r, t_total, 2 * h), generator=gen, device=x.device) if with_outputs else None
    bargs = (*fargs, hprev, cprev, dfinal, douts)
    got = bilstm_train_bwd(*bargs)
    torch.cuda.synchronize()
    want = bilstm_train_bwd_reference(*bargs)
    bwd_err, bwd_tol = 0.0, 0.0
    for field, a, b in zip(("dxf", "dxb"), got, want):
        check(torch.isfinite(a).all().item(), f"train bwd {name} {field}: non-finite kernel output")
        err, tol = max_err(a, b), TOL_LSTM_BWD * max(1.0, b.abs().max().item())
        check(err <= tol, f"train bwd {name} {field}: kernel vs plain max abs err {err:.3e} > {tol:.3e}")
        bwd_err, bwd_tol = max(bwd_err, err), max(bwd_tol, tol)
    del got, want

    fwd_ms = time_ms(lambda: bilstm_train_fwd(*fargs, with_outputs=with_outputs), 10)
    fwd_plain_ms = time_ms(lambda: bilstm_train_fwd_reference(*fargs, with_outputs=with_outputs), 3)
    bwd_ms = time_ms(lambda: bilstm_train_bwd(*bargs), 10)
    bwd_plain_ms = time_ms(lambda: bilstm_train_bwd_reference(*bargs), 3)
    lib_fwd_ms, lib_bwd_ms = cudnn_train_ms(enc, x, lengths, with_outputs, gen)

    # what these inputs need: each direction runs len_r steps of row r; a
    # step of the forward is one (H) @ (H, 4H) product, of the backward two
    # (the gates again, and dgates @ W_hh^T). Inputs are counted at the
    # valid steps, outputs in full.
    steps = t_total * r if lengths is None else int(lengths.sum().item())
    len_bytes = 4 * r if lengths is not None else 0
    res_bytes = 4 * 2 * t_total * r * 2 * h  # hprev and cprev, (T, R, 2H) each
    f_flops = 2 * steps * 2 * h * g
    f_bytes = 4 * (2 * steps * g + 2 * h * g + r * 2 * h) + len_bytes + res_bytes
    if with_outputs:
        f_bytes += 4 * r * t_total * 2 * h
    b_flops = 2 * f_flops
    b_bytes = 4 * (2 * steps * g + 2 * h * g + 2 * steps * 2 * h + r * 2 * h + 2 * t_total * r * g) + len_bytes
    if with_outputs:
        b_bytes += 4 * r * t_total * 2 * h
    f_bound, f_by = bound_ms(f_flops, f_bytes)
    b_bound, b_by = bound_ms(b_flops, b_bytes)
    say(f"bilstm_train {name}", T=t_total, R=r, H=h, masked=lengths is not None, outputs=with_outputs,
        fwd_err=f"{fwd_err:.3e}", fwd_tol=TOL_LSTM, bwd_err=f"{bwd_err:.3e}", bwd_tol=f"{bwd_tol:.3e}",
        fwd_ms=f"{fwd_ms:.4f}", fwd_plain_ms=f"{fwd_plain_ms:.4f}", fwd_cudnn_ms=f"{lib_fwd_ms:.4f}",
        fwd_bound_ms=f"{f_bound:.4f}", fwd_bound_by=f_by,
        bwd_ms=f"{bwd_ms:.4f}", bwd_plain_ms=f"{bwd_plain_ms:.4f}", bwd_cudnn_ms=f"{lib_bwd_ms:.4f}",
        bwd_bound_ms=f"{b_bound:.4f}", bwd_bound_by=b_by)
    return (
        dict(shape=name, err=fwd_err, ms=fwd_ms, plain_ms=fwd_plain_ms, library_ms=lib_fwd_ms,
             bound_ms=f_bound, flops=f_flops, bytes=f_bytes),
        dict(shape=name, err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms, library_ms=lib_bwd_ms,
             bound_ms=b_bound, flops=b_flops, bytes=b_bytes),
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


def phase_train(batch):
    """The flagship train step: warm-up steps, kernel path against plain
    path, then timed steps on the kernel path (the training path whose
    launches count) and one step under the profiler.

    The agreement is checked after the warm-up: at the seeded init every
    bias is zero, so QueryAttn l2-normalizes exactly-zero vectors at the
    padded question positions and its bias gradient is rounding noise times
    1e12, in any implementation; two updates move the biases off zero.
    """
    lr = cfg_from_file(TRAIN_CFG).train.lr
    model = build_model(seed=0, **FLAGSHIP)
    state = create_train_state(model, make_optimizer(lr, steps_per_epoch=100), seed=0)
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    rates = [m.p for m in drops]
    for _ in range(WARMUP_STEPS):
        train_step(state, batch, alpha=ALPHA, beta=BETA)

    # agreement: one step's loss and gradients from the same weights,
    # dropout off, kernel path then plain path
    for m in drops:
        m.p = 0.0
    reset_counts()
    metrics = forward_backward(state, batch, alpha=ALPHA, beta=BETA)
    torch.cuda.synchronize()
    launches = counts()
    check(launches == (0, 0, 3, 3), f"one train step launched {launches} kernels 1-4, want (0, 0, 3, 3)")
    loss_k, gn_k = metrics["loss"].item(), module_grad_norms(model)
    model.use_kernels = False
    metrics = forward_backward(state, batch, alpha=ALPHA, beta=BETA)
    loss_p, gn_p = metrics["loss"].item(), module_grad_norms(model)
    model.use_kernels = True
    check(counts() == launches, f"the plain path launched kernels: {counts()} after {launches}")
    check(np.isfinite(loss_k) and np.isfinite(loss_p), f"non-finite loss {loss_k} / {loss_p}")
    rel_loss = abs(loss_k - loss_p) / max(abs(loss_p), 1e-9)
    rel_gn = {k: abs(gn_k[k] - gn_p[k]) / max(gn_p[k], 1e-12) for k in gn_p}
    check(rel_loss <= TOL_TRAIN_LOSS, f"train loss kernel {loss_k} vs plain {loss_p}: rel {rel_loss:.2e}")
    bad = {k: f"{v:.2e}" for k, v in rel_gn.items() if not v <= TOL_TRAIN_GNORM}
    check(not bad, f"per-module gradient norms off by more than {TOL_TRAIN_GNORM}: {bad}")
    worst = max(rel_gn, key=rel_gn.get)
    say("train agreement", after_steps=WARMUP_STEPS, loss_kernel=f"{loss_k:.6f}", loss_plain=f"{loss_p:.6f}",
        rel_loss=f"{rel_loss:.2e}", worst_module=worst, worst_gnorm_rel=f"{rel_gn[worst]:.2e}",
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
    launches = counts()
    ms = start.elapsed_time(end) / TIMED_STEPS
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)), f"non-finite train losses {losses}")
    check(launches == (0, 0, 3 * TIMED_STEPS, 3 * TIMED_STEPS),
          f"{TIMED_STEPS} train steps launched {launches} kernels 1-4, want 3 + 3 per step")
    say("train", batch=BATCH, valid=BATCH - TRAIN_PAD, lr=lr, step_ms=f"{ms:.3f}",
        qa_per_s=f"{BATCH / ms * 1e3:.1f}", losses=",".join(f"{v:.5f}" for v in losses),
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        launches=f"bilstm_train_fwd:{launches[2]},bilstm_train_bwd:{launches[3]},"
                 f"bilstm_recurrence:{launches[0]},gat_cycle:{launches[1]}")
    profile_run("train profile", lambda: train_step(state, batch, alpha=ALPHA, beta=BETA))
    return launches


def train_batch(gen):
    """The flagship inputs plus answers from a seeded generator and a valid
    mask with the last TRAIN_PAD rows padded."""
    app, mot, q, qlen = flagship_inputs(BATCH, gen)
    answers = torch.randint(0, FLAGSHIP["num_answers"], (BATCH,), generator=gen, device=gen.device)
    valid = torch.ones(BATCH, device=gen.device)
    valid[-TRAIN_PAD:] = 0.0
    return app, mot, q, qlen, answers, valid


def kernel_entry(name, source, replaces, launches, cases, per, library):
    """One row of the kernels line: the sums over the cases of one step."""
    total = lambda key: sum(c[key] for c in cases)
    bms, by = bound_ms(total("flops"), total("bytes"))
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") if library else ("ms", "plain_ms", "bound_ms")
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=launches,
                max_abs_err=max(c["err"] for c in cases), ms=total("ms"), plain_ms=total("plain_ms"),
                bound_ms=bms, bound_by=by, library_ms=total("library_ms") if library else None,
                per=per, shapes={c["shape"]: {k: c[k] for k in keys} for c in cases})


def main():
    phase_device()
    phase_build()
    model = build_model(seed=0, **FLAGSHIP)
    gen = torch.Generator(device="cuda").manual_seed(0)
    app, mot, q, qlen = flagship_inputs(BATCH, gen)
    lstm_cases = phase_bilstm(model, app, q, qlen)
    gat_cases = phase_gat(model, app, mot, q, qlen)
    phase_eval(model, app, mot, q, qlen)
    del app, mot
    torch.cuda.empty_cache()
    n_lstm, n_gat = phase_serve(model)

    batch = train_batch(torch.Generator(device="cuda").manual_seed(1))
    fwd_cases, bwd_cases = phase_bilstm_train(model, batch[0], batch[2], batch[3])
    del model
    torch.cuda.empty_cache()
    train_launches = phase_train(batch)

    # kernel 1 once at each of its three shapes per flagship forward, kernel
    # 2 once per stream; kernels 3 and 4 once at each of the three shapes
    # per train step. Each row sums its cases' measurements.
    eval_shapes = "appearance + question_outputs + question_final"
    kernels = [
        kernel_entry("bilstm_recurrence", "dualvgr_tpu_torch/csrc/bilstm_recurrence.cu",
                     "dualvgr_tpu/ops/lstm_pallas.py:107", n_lstm, lstm_cases,
                     f"one flagship forward (batch 256): {eval_shapes}", library=True),
        kernel_entry("gat_cycle", "dualvgr_tpu_torch/csrc/gat_cycle.cu",
                     "dualvgr_tpu/ops/gat_pallas.py:105", n_gat, gat_cases,
                     "one flagship forward (batch 256): appearance + motion streams", library=False),
        kernel_entry("bilstm_train_fwd", "dualvgr_tpu_torch/csrc/bilstm_train_fwd.cu",
                     "dualvgr_tpu/ops/lstm_pallas_train.py:202", train_launches[2], fwd_cases,
                     f"one flagship train step (batch 256): {eval_shapes}; library: cuDNN "
                     "training-mode forward, input projection included", library=True),
        kernel_entry("bilstm_train_bwd", "dualvgr_tpu_torch/csrc/bilstm_train_bwd.cu",
                     "dualvgr_tpu/ops/lstm_pallas_train.py:239", train_launches[3], bwd_cases,
                     f"one flagship train step (batch 256): {eval_shapes}; library: cuDNN backward, "
                     "dX, dW_ih, dW_hh and the biases' gradients included", library=True),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
