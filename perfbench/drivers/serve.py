"""Serving cells: single-question requests at open-loop arrivals into the
program's ``BatchingEngine`` around ``build_predict_fn``, as its serve CLI
builds them.

The arrivals are a Poisson process at the cell's fixed rate: every seed
gets the same set of gaps (the exponential distribution's quantiles) in
another order. Each request draws one test video uniformly and one of its
questions, and is handed to ``submit`` from a pool of client threads large
enough that a due request does not wait for a free one. A request is timed
from when it was due to when ``submit`` returned; one that failed or timed
out counts as slower than every other.

``serve_p95_ms``: the 95th percentile of the window's requests. The
comparison holds the top-k ids and scores of a sample of the answered
requests, drawn from the seed with the longest questions in it, against
the reference's logits.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from perfbench.lib import data
from perfbench.lib.common import sub_seed
from perfbench.lib.harness import build_program_model, checks_of, free, logit_gap, memory_peak, score_gap
from perfbench.lib.weights import make_weights
from perfbench.reference import dualvgr as reference


def arrivals(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds into the window) of a Poisson process at ``rate``."""
    n = int(round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(np.random.default_rng(seed).permutation(gaps))


def requests(split, n: int, seed: int) -> np.ndarray:
    """``n`` question ids: a video drawn uniformly, then one of its questions."""
    rng = np.random.default_rng(seed)
    videos = rng.integers(0, len(split.starts) - 1, size=n)
    lo, hi = split.starts[videos], split.starts[videos + 1]
    return lo + (rng.random(n) * (hi - lo)).astype(np.int64)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile."""
    s = sorted(values)
    return float(s[max(0, math.ceil(q * len(s)) - 1)])


class _Served:
    """The program's serving path on the card, with the run's weights and
    test split: the predict fn (CUDA events around each call when traced),
    the engine, and ``submit``, as the serve CLI's answer path calls it."""

    def __init__(self, ctx):
        from dualvgr_tpu_torch.data.features import FeatureStore
        from dualvgr_tpu_torch.serving import BatchingEngine, build_predict_fn

        cfg, wl, dev, m = ctx.config, ctx.workload, ctx.device, ctx.model
        self.split = data.make_split(cfg, "test", ctx.seed, dev, videos=wl.get("videos"),
                                     questions=wl.get("questions"))
        ctx.stage("data")
        self.weights = make_weights(reference.param_spec(**m), ctx.seed, dev)
        self.model = build_program_model(ctx, self.weights)
        ctx.stage("weights and model")
        ids = np.arange(self.split.app.shape[0])
        self.app_store = FeatureStore.from_array(ids, self.split.app, "resnet_features")
        self.mot_store = FeatureStore.from_array(ids, self.split.mot, "resnext_features")
        predict = ctx.hook("predict", build_predict_fn(self.model, wl["top_k"], device=dev))
        rec = ctx.rec

        last_end = [None]

        def timed_predict(app, mot, q, qlen):
            rec.boundary()
            if last_end[0] is not None:
                rec.add_span("engine.between", last_end[0], time.perf_counter())
            with rec.span("predict"), rec.timed("predict"):
                out = predict(app, mot, q, qlen)
            last_end[0] = time.perf_counter()
            if rec.active:  # the batch's real rows (padding rows hold token 0) and question lengths
                real, qsum = torch.stack([(q[:, 0] != 0).sum(), qlen.sum()]).tolist()
                rec.step({"rows": int(q.shape[0]), "valid": int(real), "qlen_sum": int(qsum),
                          "q_pad": int(q.shape[1])})
            return out

        self.engine = engine = BatchingEngine(
            timed_predict, device=dev, max_batch=wl["max_batch"], max_wait_ms=wl["max_wait_ms"],
            max_q_len=wl["max_q_len"],
            feature_shapes=(tuple(self.app_store.shape[1:]), tuple(self.mot_store.shape[1:])))
        rec.on_start.append(lambda: rec.counters.update(start=engine.stats()))
        rec.on_stop.append(lambda: rec.counters.update(stop=engine.stats()))
        self.pool = ThreadPoolExecutor(max_workers=wl["clients"])
        self.timeout, self.top_k = wl["timeout_s"], wl["top_k"]

    def submit(self, qid):
        split = self.split
        v = int(split.video_ids[qid])
        question = split.questions[qid, : split.lengths[qid]]
        return self.engine.submit(self.app_store.row(v).numpy(), self.mot_store.row(v).numpy(), question,
                                  timeout=self.timeout)

    def drive(self, rate, seconds, seed, ctx=None):
        return _drive(self.pool, self.submit, rate, seconds, self.split, seed, ctx, self.top_k)

    def close(self):
        self.engine.close()
        self.pool.shutdown(wait=True)


def run(ctx):
    wl, dev, rec = ctx.workload, ctx.device, ctx.rec
    served = _Served(ctx)
    try:
        served.drive(wl["rate"], wl["warmup_seconds"], sub_seed(ctx.seed, "warmup"))
        ctx.stage("warm-up")
        seconds = wl["readings_seconds"] if ctx.readings_only else ctx.seconds
        t0 = rec.begin_window()
        qids, lat, out, _ = served.drive(wl["rate"], seconds, sub_seed(ctx.seed, "traffic"), ctx)
        t1 = time.perf_counter()
        rec.finish()
        peak = memory_peak(dev)
    finally:
        served.close()
    split, weights = served.split, served.weights
    del served
    free(dev)

    failed = int((~np.isfinite(lat)).sum())
    p95 = percentile(lat, 0.95) * 1e3
    checks = _compare(ctx, split, weights, qids, out) + checks_of(ctx, {"failed_requests": float(failed)})
    return {
        "window": (t0, t1), "attempted": len(lat), "failed": failed, "memory_peak_bytes": peak,
        "e2e": {"serve_p95_ms": p95}, "checks": checks,
    }


def _drive(pool, submit, rate, seconds, split, seed, ctx, top_k):
    """Issues the requests at their due times; returns (question ids,
    latencies in seconds, inf where failed, the answers' ids and scores,
    -1 where failed, how late each was issued). Per request it keeps only
    numbers in preallocated arrays, so that the load generator leaves no
    garbage for the collector of the program's process."""
    due = arrivals(rate, seconds, seed)
    n = len(due)
    qids = requests(split, n, seed)
    lat = np.full(n, math.inf)
    ids = np.full((n, top_k), -1, dtype=np.int64)
    scores = np.zeros((n, top_k), dtype=np.float32)
    late = np.zeros(n)
    left = [n]
    lock, finished = threading.Lock(), threading.Event()

    def job(i, t_due):
        try:
            ids[i], scores[i] = submit(qids[i])
            lat[i] = time.perf_counter() - t_due
        except Exception:  # noqa: BLE001 — a failed request counts as missing every limit
            ids[i] = -1
        finally:
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    finished.set()

    start = time.perf_counter()
    for i in range(n):
        t_due = start + due[i]
        now = time.perf_counter()
        if t_due > now:
            time.sleep(t_due - now)
        late[i] = time.perf_counter() - t_due
        pool.submit(job, i, t_due)
    if n:
        finished.wait(timeout=60.0 + seconds)
    if ctx is not None and n:
        ctx.say(f"generator: {n} requests due over {seconds} s at {rate} /s; issued late by at most "
                f"{late.max() * 1e3:.3f} ms, p99 {percentile(late, 0.99) * 1e3:.3f} ms")
    return qids, lat, (ids, scores), late


def _compare(ctx, split, weights, qids, out) -> list:
    """The sample: the longest answered questions and others drawn from the seed."""
    wl, m, dev = ctx.workload, ctx.model, ctx.device
    ids, scores = out
    answered = np.flatnonzero(ids[:, 0] >= 0)
    if len(answered) == 0:
        return checks_of(ctx, {"answered": 0.0})
    k = min(wl["checked_requests"], len(answered))
    by_length = answered[np.argsort(-split.lengths[qids[answered]], kind="stable")]
    longest = by_length[: max(1, k // 16)]
    rng = np.random.default_rng(sub_seed(ctx.seed, "serve.sample"))
    rest = np.setdiff1d(answered, longest)
    picked = np.concatenate([longest, rng.choice(rest, size=min(k - len(longest), len(rest)), replace=False)])
    id_gap = prob_gap = 0.0
    for lo in range(0, len(picked), 256):
        block = picked[lo: lo + 256]
        app, mot, q, qlen, _ = data.batch_of(split, qids[block], dev)
        with torch.no_grad():
            logits = reference.forward(weights, app, mot, q, qlen, unit_layers=m["unit_layers"],
                                       graph_layers=m["graph_layers"])[0]
        top_ids = torch.as_tensor(ids[block], device=dev)
        top_scores = torch.as_tensor(scores[block], device=dev)
        id_gap = max(id_gap, logit_gap(logits, top_ids))
        prob_gap = max(prob_gap, score_gap(logits, top_ids, top_scores))
    ctx.say(f"compared {len(picked)} answered requests (question lengths up to "
            f"{int(split.lengths[qids[picked]].max())}): top-k logit gap {id_gap:.3e}, score gap {prob_gap:.3e}")
    return checks_of(ctx, {"topk_logit_gap": id_gap, "topk_score_gap": prob_gap})
