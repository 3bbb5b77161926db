"""Request batching around the serving program: forward + softmax + top-k.

``BatchingEngine`` is the port's own copy of the JAX package's single-program
batcher (``dualvgr_tpu/serving.py``): callers block in :meth:`submit`; one
worker thread waits at most ``max_wait_ms`` past the first queued request
to fill up to ``max_batch``, pads the batch to ``max_batch``, runs
``predict_fn`` once and fans the rows back out. Here the worker assembles
the padded batch straight into host staging tensors that it reuses (pinned
when the engine's device is CUDA), copies them to the engine's ``device``
without blocking and runs the CUDA work with that device current (the
current device is per thread). A batch's results are fetched before the
next batch is assembled, and the copies' event is waited on first, so a
staging tensor is never rewritten under a copy in flight.

``ReplicatedEngine`` is the counterpart of the JAX package's replicated
engine: one ``BatchingEngine`` per replica, round-robin dispatch;
``per_device_predict_fns`` gives it one predict fn per card, from a model
(its weights copied to each card) or from an export artifact
(``dualvgr_tpu_torch/export.py``) loaded on each card.

``build_predict_fn(model, top_k)`` runs the serving program (the
counterpart of ``dualvgr_tpu/export.py::build_predict_fn``), the module
``ServingProgram`` that ``export.py`` exports: the eval forward, softmax
and top-k run on the card and only the (B, k) ids and scores come back to
the host.
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dualvgr_tpu_torch.utils.device import resolve_device

__all__ = ["BatchingEngine", "ReplicatedEngine", "Request", "EngineStats", "ServingProgram",
           "build_predict_fn", "per_device_predict_fns"]


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

    program = ServingProgram(model, top_k)

    @torch.no_grad()
    def predict(app, mot, q, qlen):
        app, mot = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (app, mot))
        q, qlen = (torch.as_tensor(a, device=dev) for a in (q, qlen))
        top_i, top_p = program(app, mot, q, qlen)
        return top_i.cpu().numpy(), top_p.cpu().numpy()

    return predict


class ServingProgram(torch.nn.Module):
    """The serving program as a module: the eval forward, softmax and
    top-k, ``(ids, scores)`` (B, top_k) each on the model's device; what
    ``build_predict_fn`` runs and ``export.export_serving`` exports."""

    def __init__(self, model, top_k: int):
        super().__init__()
        self.model = model
        self.top_k = int(top_k)

    def forward(self, app, mot, q, qlen):
        probs = torch.softmax(self.model(app, mot, q, qlen).logits, dim=-1)
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        return top_i, top_p


def per_device_predict_fns(model_or_artifact, top_k: int | None = None, devices=None) -> list:
    """One predict fn per card, for :class:`ReplicatedEngine` (the
    counterpart of the JAX package's ``export.per_device_predict_fns``).

    ``model_or_artifact`` is a model (each card gets its own copy of the
    weights, the card it lives on the model itself; ``top_k`` is then
    needed) or the path of an export artifact (loaded on each card).
    ``devices`` defaults to every card; raises if it names more cards than
    ``torch.cuda.device_count()`` holds.
    """
    count = torch.cuda.device_count()
    devices = [f"cuda:{i}" for i in range(count)] if devices is None else list(devices)
    devs = [torch.device(d) for d in devices]
    if not devs or any(d.type != "cuda" for d in devs):
        raise ValueError(f"per_device_predict_fns places replicas on CUDA devices, got {devices}")
    if len(devs) > count or any(d.index is not None and d.index >= count for d in devs):
        raise ValueError(f"{len(devs)} replicas on {devices}, but torch.cuda.device_count() is {count}")
    if isinstance(model_or_artifact, str):
        from dualvgr_tpu_torch.export import load_artifact

        return [load_artifact(model_or_artifact, device=d)[0] for d in devs]
    if top_k is None:
        raise ValueError("per_device_predict_fns(model) needs top_k")
    return [build_predict_fn(model_on(model_or_artifact, resolve_device(d)), top_k, device=d) for d in devs]


def model_on(model, device: torch.device):
    """``model`` if its weights are on ``device``, else a copy moved there."""
    if {p.device for p in model.parameters()} == {device}:
        return model
    return copy.deepcopy(model).to(device)


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
    latencies_ms: list = field(default_factory=list)

    def snapshot(self) -> dict:
        lat = sorted(self.latencies_ms)
        q = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)] if lat else None
        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch": (self.requests / self.batches) if self.batches else None,
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
        self._staging = None  # host batch tensors, made at the first batch of their shapes
        self._staged_rows = 0  # rows of the staging tensors the last batch wrote
        self._copied = None  # CUDA event after the last batch's copies
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
        on_card = torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()
        with on_card:
            self._serve()

    def _serve(self):
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
                for req in batch:
                    if len(self._stats.latencies_ms) < 100_000:
                        self._stats.latencies_ms.append((now - req._t_submit) * 1e3)

    def _step(self, batch: list):
        n = len(batch)
        host = self._assemble(batch)
        args = self._to_device(host)
        # copies: a predict fn's outputs may be views of the staging tensors
        return tuple(np.array(_host(x)[:n]) for x in self._predict_fn(*args))

    def _assemble(self, batch: list) -> tuple:
        """The padded batch in the staging tensors (app, mot, q, qlen):
        the requests' rows, then the rows the previous batch left beyond
        them reset to padding (zero features, length 1 over token 0)."""
        if self._copied is not None:
            self._copied.synchronize()  # the last batch's copies have read the staging tensors
        app_shape, mot_shape = batch[0].appearance.shape, batch[0].motion.shape
        if self._staging is None or self._staging[0].shape[1:] != app_shape \
                or self._staging[1].shape[1:] != mot_shape:
            pin = self.device.type == "cuda"
            b = self.max_batch
            self._staging = (
                torch.zeros((b, *app_shape), dtype=torch.float32, pin_memory=pin),
                torch.zeros((b, *mot_shape), dtype=torch.float32, pin_memory=pin),
                torch.zeros((b, self.max_q_len), dtype=torch.int32, pin_memory=pin),
                torch.ones((b,), dtype=torch.int32, pin_memory=pin),
            )
            self._staged_rows = 0
        app, mot, q, qlen = (t.numpy() for t in self._staging)  # views of the staging tensors
        n = len(batch)
        for i, req in enumerate(batch):
            length = req.question.shape[0]
            app[i], mot[i] = req.appearance, req.motion
            q[i, :length], q[i, length:] = req.question, 0
            qlen[i] = length
        if self._staged_rows > n:
            stale = slice(n, self._staged_rows)
            app[stale], mot[stale], q[stale], qlen[stale] = 0.0, 0.0, 0, 1
        self._staged_rows = n
        return self._staging

    def _to_device(self, host: tuple) -> tuple:
        """The staging tensors on the engine's device: copies from pinned
        memory that do not block the host, their completion recorded."""
        if self.device.type != "cuda":
            return host
        args = tuple(t.to(self.device, non_blocking=True) for t in host)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return args

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


class ReplicatedEngine:
    """One :class:`BatchingEngine` per replica, round-robin dispatch (the
    counterpart of the JAX package's ``serving.ReplicatedEngine``).

    ``predict_fns`` is one fixed-shape predict fn per replica
    (:func:`per_device_predict_fns`), ``devices`` the device of each
    (default: ``engine_kwargs``' ``device`` for all). The model saturates
    a card at small batches, so serving scales across cards by
    replication: each card gets its own copy of the program and weights and
    its own batcher, with no traffic between cards. The submit, stats and
    close surface matches :class:`BatchingEngine`.
    """

    def __init__(self, predict_fns, *, devices=None, **engine_kwargs):
        if not predict_fns:
            raise ValueError("need at least one predict_fn")
        name = engine_kwargs.pop("name", "dualvgr-serve")
        device = engine_kwargs.pop("device", "cuda")
        devices = [device] * len(predict_fns) if devices is None else list(devices)
        if len(devices) != len(predict_fns):
            raise ValueError(f"{len(predict_fns)} predict fns for {len(devices)} devices")
        self._engines = []
        try:
            for i, (fn, dev) in enumerate(zip(predict_fns, devices)):
                self._engines.append(BatchingEngine(fn, device=dev, name=f"{name}-r{i}", **engine_kwargs))
        except BaseException:
            self.close()
            raise
        self._next = 0
        self._lock = threading.Lock()

    # the engine attributes that serve.py's warm-up and handler read
    @property
    def max_batch(self):
        return self._engines[0].max_batch

    @property
    def _feature_shapes(self):
        return self._engines[0]._feature_shapes

    @property
    def replicas(self) -> int:
        return len(self._engines)

    def submit(self, appearance, motion, question, timeout=30.0):
        with self._lock:
            i = self._next
            self._next = (i + 1) % len(self._engines)
        return self._engines[i].submit(appearance, motion, question, timeout)

    def stats(self) -> dict:
        per = [e.stats() for e in self._engines]
        lat = []
        for e in self._engines:
            with e._lock:
                lat += e._stats.latencies_ms
        lat.sort()
        q = lambda p: lat[min(int(p * len(lat)), len(lat) - 1)] if lat else None
        total_b = sum(s["batches"] for s in per)
        requests = sum(s["requests"] for s in per)
        return {
            "replicas": len(per),
            "requests": requests,
            "batches": total_b,
            "mean_batch": requests / total_b if total_b else None,
            "latency_ms_p50": q(0.50),
            "latency_ms_p99": q(0.99),
            "per_replica": per,
        }

    def close(self, timeout: float = 10.0):
        for e in self._engines:
            e.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
