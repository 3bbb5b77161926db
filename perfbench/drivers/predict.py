"""Raw-video cells: ``predict.predict_frames`` on one test video and all of
its questions a call, back to back, as the predict CLI calls it: decoded
frames in, clip sampling and resize on the card, both backbones, then
DualVGR's eval forward, the logits fetched to the host.

Set-up makes from the seed: the test split's questions, as text over the
configuration's vocabulary (``lib/data.py``'s draw: its lengths and first
words); a pool of decoded videos, uniform-noise uint8 frames at the
configuration's size in pageable host memory as a decoder gives them, their
lengths the quantiles of the configuration's length distribution in the
seed's order; the backbones' weights (``lib/video_weights.py``), written as
checkpoints that the port's extractors load as the CLI's ``--*_ckpt`` do;
and DualVGR's. Then it warms up.

Call k takes the split's k-th video (in the seed's order) with all of its
questions, and the frames of pool video k mod P, with k written into a
16 x 16 patch of every frame first, so that no two calls see the same
pixels and no cache across calls can answer one.

``eval_qa_per_s``: the questions of the window's calls over the seconds
from the window's start to the end of its last call; calls start until the
window's end, so a call's length does not quantise the rate.

The comparison takes the window's first call and one drawn from the seed:
for each, the reference (``reference/video.py``, then
``reference/dualvgr.py``) runs the whole path from the same frames,
weights and token ids. ``answer_logit_gap`` is ``harness.logit_gap`` of
the port's answers; ``logit_rel_gap`` the largest |port - reference| of a
row over the row's largest |logit|.

With ``--trace 1`` the port's tracer (``utils/trace.py``) is on over the
traced window, and its spans and counters reach the readers as
``trace.counters["program"]`` = {"spans": {name: [seconds]}, "counters":
{name: total}}; a program without them leaves those empty.

Faults this driver plants (``Context.faults``): ``answer``, one answer
altered at the output; ``tf32``, the backbones' convs in TF32 (the control
of the precision just below fp32 for the convs; DualVGR's products stay
fp32).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from collections import defaultdict
from unittest import mock

import numpy as np
import torch

from perfbench.lib import data
from perfbench.lib.common import sub_seed
from perfbench.lib.harness import build_program_model, checks_of, free, logit_gap, memory_peak
from perfbench.lib.video_weights import make_backbone_weights
from perfbench.lib.weights import make_weights
from perfbench.reference import dualvgr as reference
from perfbench.reference import video as video_reference

STAMP = 16  # the side of the patch that carries a call's index


def questions_of(cfg: dict, seed: int):
    """(the test split as ``data.make_split`` draws it, each question as
    text). The split's features are not read here: they are drawn at one
    number a video."""
    shape_free = copy.deepcopy(cfg)
    shape_free["model"].update(num_of_nodes=1, frames_per_clip=1, vision_dim=1)
    split = data.make_split(shape_free, "test", seed, "cpu")
    words = {i: w for w, i in split.vocab["question_token_to_idx"].items()}
    texts = [" ".join(words[int(t)] for t in row[:n]) + "?" for row, n in zip(split.questions, split.lengths)]
    return split, texts


def video_lengths(video: dict, n: int, seed: int) -> np.ndarray:
    """``n`` frame counts: the quantiles of offset + Exponential(mean),
    rounded and clipped to max, in the seed's order."""
    d = video["frames"]
    p = (np.arange(n) + 0.5) / n
    t = np.clip(np.rint(d["offset"] - d["mean"] * np.log1p(-p)), 1, d["max"]).astype(np.int64)
    return np.random.default_rng(sub_seed(seed, "predict.lengths")).permutation(t)


def frame_pool(video: dict, n: int, seed: int, device) -> list:
    """``n`` decoded videos, (T, H, W, 3) uint8 numpy arrays of uniform noise,
    drawn on ``device`` and brought to pageable host memory."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "predict.frames"))
    h, w = video["frame_height"], video["frame_width"]
    return [torch.randint(0, 256, (int(t), h, w, 3), generator=gen, device=device, dtype=torch.uint8).cpu().numpy()
            for t in video_lengths(video, n, seed)]


def stamp(frames: np.ndarray, k: int) -> np.ndarray:
    """``frames`` with call ``k``'s index in the top left patch of every
    frame: byte c of k in channel c."""
    frames[:, :STAMP, :STAMP, :] = np.asarray([(k >> 8 * c) & 255 for c in range(3)], np.uint8)
    return frames


def _answer(fn, ctx):
    """One answer altered where it is produced: row 0's next answer raised
    above its best."""
    def call(*args, **kw):
        out = fn(*args, **kw).clone()
        best, top = out[0].max(), int(out[0].argmax())
        out[0, (top + 1) % out.shape[1]] = best + out[0].abs().max() + 1.0
        return out
    return call


def _tf32(fn, ctx):
    """The backbones' convs in TF32: the extractors' fp32 guard lifted and
    cuDNN's TF32 on for the call."""
    from dualvgr_tpu_torch.preprocess import features

    def call(*args, **kw):
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            with mock.patch.object(features, "_cudnn_fp32", lambda on: contextlib.nullcontext()):
                return fn(*args, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = saved
    return call


FAULTS = {"answer": _answer, "tf32": _tf32}


class _Program:
    """The port's raw-video path on the card with the run's weights."""

    def __init__(self, ctx, vocab: dict):
        from dualvgr_tpu_torch import predict
        from dualvgr_tpu_torch.preprocess.features import build_appearance_extractor, build_motion_extractor

        cfg, dev = ctx.config, ctx.device
        bb, self.video = cfg["backbones"], cfg["video"]
        dtype = ctx.compute_dtype
        self.app_weights = make_backbone_weights(video_reference.resnet101_spec(bb["appearance"]["layers"]),
                                                 ctx.seed, "appearance", dev)
        self.mot_weights = make_backbone_weights(
            video_reference.resnext101_spec(bb["motion"]["layers"], bb["motion"]["cardinality"]), ctx.seed,
            "motion", dev, raw_input=True)
        # the checkpoints as published: torchvision's state_dict, and the
        # Kinetics release's DataParallel one under "state_dict"
        app_ckpt, mot_ckpt = os.path.join(ctx.tmpdir, "resnet101.pth"), os.path.join(ctx.tmpdir, "resnext101.pth")
        torch.save({k: v.cpu() for k, v in self.app_weights.items()}, app_ckpt)
        torch.save({"arch": "resnext-101", "state_dict": {f"module.{k}": v.cpu() for k, v in self.mot_weights.items()}},
                   mot_ckpt)
        self.app_x = build_appearance_extractor(app_ckpt, dev, dtype, tuple(bb["appearance"]["layers"]))
        self.mot_x = build_motion_extractor(mot_ckpt, dev, dtype, tuple(bb["motion"]["layers"]))
        ctx.stage("backbones")
        self.weights = make_weights(reference.param_spec(**ctx.model), ctx.seed, dev)
        self.model = build_program_model(ctx, self.weights)
        ctx.stage("weights and model")
        fn = predict.predict_frames
        for fault in ctx.faults:
            fn = FAULTS[fault](fn, ctx)
        self.predict_frames = fn
        self.dev, self.vocab = dev, vocab

    def __call__(self, frames, texts):
        v = self.video
        return self.predict_frames([frames] * len(texts), texts, model=self.model, vocab=self.vocab,
                                   app_extract=self.app_x, mot_extract=self.mot_x, num_clips=v["num_clips"],
                                   appearance_size=v["appearance_size"], motion_size=v["motion_size"],
                                   device=self.dev)


def run(ctx):
    cfg, wl, dev, rec = ctx.config, ctx.workload, ctx.device, ctx.rec
    split, texts = questions_of(cfg, ctx.seed)
    order = np.random.default_rng(sub_seed(ctx.seed, "predict.order")).permutation(len(split.starts) - 1)
    pool = frame_pool(cfg["video"], wl["pool_videos"], ctx.seed, dev)
    ctx.stage("data")
    program = _Program(ctx, split.vocab)
    calls = []  # (k, video, questions, logits on the host) of each call since the warm-up

    def one_call(k: int):
        v = int(order[k % len(order)])
        qids = range(int(split.starts[v]), int(split.starts[v + 1]))
        frames = stamp(pool[k % len(pool)], k)
        with rec.span("predict_call"):
            with rec.timed("predict_frames"):
                logits = program(frames, [texts[i] for i in qids])
            host = logits.float().cpu()  # as the CLI fetches them
        calls.append((k, v, qids, host))
        rec.step({"questions": len(qids)})
        return len(qids)

    if ctx.trace:
        from dualvgr_tpu_torch.utils import trace as program_trace

        def tracer_on():
            program_trace.spans(), program_trace.counters()
            program_trace.enable()

        def tracer_off():
            program_trace.disable()
            spans = defaultdict(list)
            for s in program_trace.spans():
                spans[s.name].append((s.end_ns - s.start_ns) / 1e9)
            rec.counters["program"] = {"spans": dict(spans), "counters": program_trace.counters()}

        rec.on_start.append(tracer_on)
        rec.on_stop.append(tracer_off)

    k = 0
    t_warm = time.perf_counter()
    while k < wl["warmup_calls"] or time.perf_counter() < t_warm + wl["warmup_seconds"]:
        one_call(k)
        k += 1
    ctx.stage("warm-up")
    calls.clear()
    questions = 0
    if not ctx.readings_only:
        t0 = rec.begin_window()
        last_end = None
        while time.perf_counter() < t0 + ctx.seconds:
            rec.boundary()
            if last_end is not None:
                rec.add_span("predict.between", last_end, time.perf_counter())
            questions += one_call(k)
            k += 1
            last_end = time.perf_counter()
        t1 = last_end
        rec.finish()
    else:
        t0 = t1 = time.perf_counter()
        for _ in range(wl["readings_calls"]):
            one_call(k)
            k += 1
    peak = memory_peak(dev)
    weights = (program.app_weights, program.mot_weights, program.weights)
    del program
    free(dev)

    checks = _compare(ctx, split, pool, calls, weights)
    return {
        "window": (t0, t1), "attempted": questions, "failed": 0, "memory_peak_bytes": peak,
        "e2e": {"eval_qa_per_s": questions / (t1 - t0) if t1 > t0 else 0.0}, "checks": checks,
    }


def _sample(ctx, n: int) -> list:
    """The calls compared: the first, and one other drawn from the seed."""
    if n < 2:
        return list(range(n))
    return [0, 1 + int(np.random.default_rng(sub_seed(ctx.seed, "predict.sample")).integers(n - 1))]


def _compare(ctx, split, pool, calls, weights) -> list:
    """The reference's whole path on the sampled calls' frames and
    questions, against the logits the port returned."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # the reference in fp32
    try:
        answer_gaps, rel_gaps = _gaps(ctx, split, pool, calls, weights)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return checks_of(ctx, {"answer_logit_gap": max(answer_gaps), "logit_rel_gap": max(rel_gaps)})


def _gaps(ctx, split, pool, calls, weights):
    cfg, m, dev = ctx.config, ctx.model, ctx.device
    app_w, mot_w, dualvgr_w = weights
    bb, v = cfg["backbones"], cfg["video"]
    answer_gaps, rel_gaps = [], []
    for i in _sample(ctx, len(calls)):
        k, video, qids, port = calls[i]
        frames = torch.from_numpy(stamp(pool[k % len(pool)], k)).to(dev)
        idx = np.asarray(qids)
        qlen = split.lengths[idx]
        q = torch.as_tensor(split.questions[idx, : int(qlen.max())], device=dev)
        with torch.no_grad():
            app, mot = video_reference.video_features(
                app_w, mot_w, frames, num_clips=v["num_clips"], frames_per_clip=v["frames_per_clip"],
                appearance_size=v["appearance_size"], motion_size=v["motion_size"],
                layers=bb["appearance"]["layers"], cardinality=bb["motion"]["cardinality"])
            n = len(idx)
            logits = reference.forward(dualvgr_w, app.expand(n, *app.shape), mot.expand(n, *mot.shape), q,
                                       torch.as_tensor(qlen, device=dev), unit_layers=m["unit_layers"],
                                       graph_layers=m["graph_layers"])[0].double().cpu()
        port = port.double()
        answer_gaps.append(logit_gap(logits, port.argmax(dim=1)))
        scale = logits.abs().max(dim=1).values.clamp(min=1e-30)
        rel_gaps.append(float(((port - logits).abs().max(dim=1).values / scale).max()))
        ctx.say(f"compared call {k} (video {video}, {n} questions): answer gap {answer_gaps[-1]:.3e}, "
                f"logit gap {rel_gaps[-1]:.3e}")
    return answer_gaps, rel_gaps
