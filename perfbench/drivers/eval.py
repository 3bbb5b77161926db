"""Evaluation cells: ``validate_lib.validate`` with ``train_lib.pred_step``
over a test split, pass after pass, through the program's loader.

Each pass is one call of ``validate`` on a fresh pass of the loader, so its
start-up (the producer thread, the first gathers) counts. The window's
last pass is cut at the window's end: the loader hands out no batch after
it, and ``validate`` finishes the ones it holds.

``eval_qa_per_s``: the questions answered in the window over its seconds.
The comparison takes a sample of the window's batches, drawn from the
seed, and holds each prediction against the reference's logits.
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace

import numpy as np
import torch

from perfbench.lib import data
from perfbench.lib.common import sub_seed
from perfbench.lib.harness import build_program_model, checks_of, free, logit_gap, memory_peak
from perfbench.lib.weights import make_weights
from perfbench.reference import dualvgr as reference


class _Pass:
    """One pass of the program's loader that stops handing out batches at
    ``deadline``, and notes each batch's questions for the comparison."""

    def __init__(self, loader, deadline, notes):
        self.loader, self.deadline, self.notes = loader, deadline, notes
        self.vocab = loader.vocab

    def __iter__(self):
        it = iter(self.loader)
        try:
            for b in it:
                self.notes.append(b)
                yield b
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    break
        finally:
            it.close()


def run(ctx):
    from dualvgr_tpu_torch import train_lib, validate_lib
    from dualvgr_tpu_torch.data.features import FeatureStore
    from dualvgr_tpu_torch.data.loader import VideoQADataLoader

    cfg, wl, dev, m = ctx.config, ctx.workload, ctx.device, ctx.model
    split = data.make_split(cfg, "test", ctx.seed, dev, videos=wl.get("videos"), questions=wl.get("questions"))
    question_pt, vocab_json = data.write_files(split, ctx.tmpdir, cfg["name"] + "_test")
    ctx.stage("data")
    weights = make_weights(reference.param_spec(**m), ctx.seed, dev)
    model = build_program_model(ctx, weights)
    ctx.stage("weights and model")
    ids = np.arange(split.app.shape[0])
    loader = VideoQADataLoader(
        question_pt=question_pt, vocab_json=vocab_json,
        appearance_feat=FeatureStore.from_array(ids, split.app, "resnet_features"),
        motion_feat=FeatureStore.from_array(ids, split.mot, "resnext_features"),
        batch_size=wl["batch_size"], shuffle=False, num_workers=cfg["train"]["num_workers"],
        prefetch=wl["prefetch"], pin_memory=dev.type == "cuda")
    vcfg = SimpleNamespace(dataset=SimpleNamespace(name=cfg["dataset_name"]), tpu=SimpleNamespace(mesh_axis="data"))
    pred_step = ctx.hook("pred_step", train_lib.pred_step)
    rec = ctx.rec
    notes = collections.deque()  # host batches handed out, not yet evaluated
    done = []  # (question ids, valid, predictions on the card) of each evaluated batch
    last_end, pass_start = [None], [None]

    def eval_fn(state, inputs):
        rec.boundary()
        t = time.perf_counter()
        if last_end[0] is not None:
            rec.add_span("eval.between", last_end[0], t)
        else:  # a pass's start-up: its loader's producer and first gathers
            rec.add_span("eval.pass_start", pass_start[0], t)
        host = notes.popleft()
        rec.step({"rows": int(host.valid.shape[0]), "valid": int(host.valid.sum()),
                  "qlen_sum": int(host.question_len.sum()), "q_pad": int(host.question.shape[1])})
        with rec.span("pred_step"), rec.timed("pred_step"):
            out = pred_step(state, inputs)
        done.append((host.question_idx, host.valid, out))
        last_end[0] = time.perf_counter()
        return out

    def one_pass(deadline):
        last_end[0] = None
        pass_start[0] = time.perf_counter()
        validate_lib.validate(vcfg, eval_fn, model, _Pass(loader, deadline, notes), device=dev,
                              prefetch=wl["prefetch"])

    try:
        one_pass(time.perf_counter() + wl["warmup_seconds"])  # warm-up: a pass's first batches
        ctx.stage("warm-up")
        done.clear()
        questions = 0
        if not ctx.readings_only:
            t0 = rec.begin_window()
            while time.perf_counter() < t0 + ctx.seconds:
                one_pass(t0 + ctx.seconds)
            t1 = time.perf_counter()
            rec.finish()
            questions = int(sum(v.sum() for _, v, _ in done))
        else:
            t0 = t1 = time.perf_counter()
            one_pass(time.perf_counter() + wl["readings_seconds"])
        peak = memory_peak(dev)
        picked = _sample(ctx, len(done))
        sample = [(done[i][0], done[i][1], done[i][2].cpu()) for i in picked]
    finally:
        loader.close()
    del model, loader, done
    free(dev)

    checks = _compare(ctx, split, weights, sample)
    return {
        "window": (t0, t1), "attempted": questions, "failed": 0, "memory_peak_bytes": peak,
        "e2e": {"eval_qa_per_s": questions / (t1 - t0) if t1 > t0 else 0.0}, "checks": checks,
    }


def _sample(ctx, n: int) -> list:
    """The batches compared: the first, the last, and others drawn from the seed."""
    k = min(ctx.workload["checked_batches"], n)
    rng = np.random.default_rng(sub_seed(ctx.seed, "eval.sample"))
    middle = rng.choice(np.arange(1, n - 1), size=max(k - 2, 0), replace=False) if n > 2 else []
    return sorted({0, n - 1, *map(int, middle)})


def _compare(ctx, split, weights, sample) -> list:
    m, dev = ctx.model, ctx.device
    gaps = []
    answered = 0
    for qids, valid, preds in sample:
        keep = valid > 0
        app, mot, q, qlen, _ = data.batch_of(split, qids[keep], dev)
        with torch.no_grad():
            logits = reference.forward(weights, app, mot, q, qlen, unit_layers=m["unit_layers"],
                                       graph_layers=m["graph_layers"])[0]
        gaps.append(logit_gap(logits, preds[torch.as_tensor(keep)].to(dev)))
        answered += int(keep.sum())
    ctx.say(f"compared {answered} answers of {len(sample)} batches; widest logit gap {max(gaps):.3e}")
    return checks_of(ctx, {"answer_logit_gap": max(gaps)})
