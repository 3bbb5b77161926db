"""Request batching around the serving program: forward + softmax + top-k.

``BatchingEngine`` is the port's own copy of the JAX package's single-program
batcher (``dualvgr_tpu/serving.py``): callers block in :meth:`submit`; one
worker thread waits at most ``max_wait_ms`` past the first queued request
to fill up to ``max_batch``, pads the batch to ``max_batch``, runs
``predict_fn`` once and fans the rows back out. Here the padded batch is
copied to the engine's ``device`` as torch tensors before the call.

``build_predict_fn(model, top_k)`` is the serving program (the counterpart
of ``dualvgr_tpu/export.py::build_predict_fn``): the eval forward, softmax
and top-k run on the card and only the (B, k) ids and scores come back to
the host.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dualvgr_tpu_torch.utils.device import resolve_device

__all__ = ["BatchingEngine", "Request", "EngineStats", "build_predict_fn"]


def build_predict_fn(model, top_k: int, *, device: str | torch.device = "cuda"):
    """``predict(app, mot, q, qlen) -> (ids, scores)``, numpy (B, top_k) each.

    The inputs may be numpy arrays or tensors; they are moved to ``device``,
    where ``model`` must already live. Raises on a machine without CUDA
    unless ``device='cpu'``, and if the model is elsewhere.
    """
    dev = resolve_device(device)
    where = {p.device for p in model.parameters()}
    if where != {dev}:
        raise ValueError(f"model parameters are on {sorted(map(str, where))}, not {dev}")

    @torch.no_grad()
    def predict(app, mot, q, qlen):
        app, mot = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (app, mot))
        q, qlen = (torch.as_tensor(a, device=dev) for a in (q, qlen))
        probs = torch.softmax(model(app, mot, q, qlen).logits, dim=-1)
        top_p, top_i = torch.topk(probs, top_k, dim=-1)
        return top_i.cpu().numpy(), top_p.cpu().numpy()

    return predict


@dataclass
class Request:
    """One QA pair, host-side. ``question`` is int32 token ids (any length
    <= the engine's ``max_q_len``; longer is an error, shorter is padded)."""

    appearance: np.ndarray  # (num_clips, frames_per_clip, D)
    motion: np.ndarray  # (num_clips, D)
    question: np.ndarray  # (L,) int32 vocab ids
    _done: threading.Event = field(default_factory=threading.Event, repr=False)
    _result: tuple | None = field(default=None, repr=False)
    _error: BaseException | None = field(default=None, repr=False)
    _t_submit: float = 0.0


@dataclass
class EngineStats:
    requests: int = 0
    batches: int = 0
    occupancy_sum: int = 0
    latencies_ms: list = field(default_factory=list)

    def snapshot(self) -> dict:
        lat = sorted(self.latencies_ms)
        q = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)] if lat else None
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": (self.occupancy_sum / self.batches) if self.batches else None,
            "latency_ms_p50": q(0.50),
            "latency_ms_p99": q(0.99),
        }


class BatchingEngine:
    """Single-program request batcher around a fixed-shape predict fn.

    ``predict_fn(app, motion, q, qlen)`` gets tensors on ``device`` with
    leading dim ``max_batch`` and returns a tuple of arrays with the same
    leading dim (e.g. top-k ids and scores); rows past the real occupancy
    are padding and their outputs are discarded.
    """

    def __init__(
        self,
        predict_fn,
        *,
        device: str | torch.device = "cuda",
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        max_q_len: int = 32,
        feature_shapes: tuple | None = None,
        name: str = "dualvgr-serve",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.device = resolve_device(device)
        self._predict_fn = predict_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_q_len = int(max_q_len)
        self._feature_shapes = feature_shapes  # ((app...), (mot...)) or None
        self._queue: queue.Queue = queue.Queue()
        self._stats = EngineStats()
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._worker = threading.Thread(target=self._run, name=f"{name}-worker", daemon=True)
        self._worker.start()

    # ---------------------------------------------------------------- submit
    def submit(self, appearance, motion, question, timeout: float | None = 30.0):
        """Block until the answer for this request is available; returns the
        per-request row of each of ``predict_fn``'s outputs."""
        if self._closed.is_set():
            raise RuntimeError("engine is closed")
        question = np.asarray(question, np.int32).reshape(-1)
        if question.shape[0] > self.max_q_len:
            raise ValueError(f"question length {question.shape[0]} > max_q_len {self.max_q_len}")
        if question.shape[0] == 0:
            raise ValueError("empty question")
        req = Request(
            appearance=np.asarray(appearance, np.float32),
            motion=np.asarray(motion, np.float32),
            question=question,
        )
        if self._feature_shapes is not None:
            want_app, want_mot = self._feature_shapes
            if req.appearance.shape != tuple(want_app):
                raise ValueError(f"appearance shape {req.appearance.shape} != {tuple(want_app)}")
            if req.motion.shape != tuple(want_mot):
                raise ValueError(f"motion shape {req.motion.shape} != {tuple(want_mot)}")
        req._t_submit = time.perf_counter()
        self._queue.put(req)
        if not req._done.wait(timeout):
            raise TimeoutError("inference timed out")
        if req._error is not None:
            raise req._error
        return req._result

    # ---------------------------------------------------------------- worker
    def _collect(self) -> list:
        """One batch: block for the first request, then fill until
        ``max_batch`` or ``max_wait_ms`` past the first arrival."""
        while True:
            try:
                first = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._closed.is_set():
                    return []
        if first is None:  # close() sentinel
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # keep the sentinel for the next loop
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while not self._closed.is_set():
            batch = self._collect()
            if not batch:
                if self._closed.is_set():
                    break
                continue
            try:
                out = self._step(batch)
                for i, req in enumerate(batch):
                    req._result = tuple(x[i] for x in out)
                    req._done.set()
            except Exception as e:  # noqa: BLE001 — fan the error out to the callers
                for req in batch:
                    req._error = e
                    req._done.set()
            now = time.perf_counter()
            with self._lock:
                self._stats.requests += len(batch)
                self._stats.batches += 1
                self._stats.occupancy_sum += len(batch)
                for req in batch:
                    if len(self._stats.latencies_ms) < 100_000:
                        self._stats.latencies_ms.append((now - req._t_submit) * 1e3)

    def _step(self, batch: list):
        n = len(batch)
        b = self.max_batch
        app = np.zeros((b,) + batch[0].appearance.shape, np.float32)
        mot = np.zeros((b,) + batch[0].motion.shape, np.float32)
        q = np.zeros((b, self.max_q_len), np.int32)
        qlen = np.ones((b,), np.int32)  # padding rows: length 1 over token 0
        for i, req in enumerate(batch):
            app[i] = req.appearance
            mot[i] = req.motion
            q[i, : req.question.shape[0]] = req.question
            qlen[i] = req.question.shape[0]
        args = (torch.from_numpy(a).to(self.device) for a in (app, mot, q, qlen))
        return tuple(_host(x)[:n] for x in self._predict_fn(*args))

    # ---------------------------------------------------------------- admin
    def stats(self) -> dict:
        with self._lock:
            return self._stats.snapshot()

    def close(self, timeout: float = 10.0):
        if self._closed.is_set():
            return
        self._closed.set()
        self._queue.put(None)
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
