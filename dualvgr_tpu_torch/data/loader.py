"""Host-side data pipeline: question pickles + clip features -> batches.

The port's own copy of the JAX package's ``data/loader.py`` (a behavioral
port of reference DataLoader.py:45-168), which it matches batch for batch:

* question pickle keys: ``questions`` (int, right-padded with <NULL>=0),
  ``questions_len``, ``question_id``, ``video_ids``, ``answers``, ``glove``
  (train only), ``question_category`` (SVQA only, ints or the reference's
  strings, ``QUESTION_CATEGORY``) — reference preprocess/datautils/
  svqa.py:128-140;
* ``train_num/val_num/test_num`` head-truncation (DataLoader.py:110-138);
* ``len(loader)`` = ceil(n / batch_size) (DataLoader.py:167-168);
* the final partial batch PADDED to the full batch size with its last row
  and marked in ``valid``, so that loss, accuracy and batch statistics
  count exactly the true samples;
* ``np.random.RandomState(seed)`` shuffling once per epoch;
* a daemon producer thread filling a bounded queue, retired when an epoch
  ends, is abandoned or the loader is closed.

A ``Batch`` carries its features as CPU tensors in the transfer dtype
(``float32`` or ``bfloat16``; a bf16 batch cannot be a numpy array) and the
rest as numpy arrays. With ``pin_memory`` the features are gathered
straight into pinned (page-locked) tensors, which the card copies from
asynchronously (``parallel.mesh.prefetch_to_device``); the CLIs set it
when the device is CUDA. ``appearance_feat`` and ``motion_feat`` take a
path or a ``FeatureStore``. A failure in the producer is raised in the
consumer (the JAX loader ends the epoch early instead). ``num_workers``
(the reference's forked workers) is, as in the JAX loader, the thread count
of the native row gather (``data/native.py``; 0: ``min(cpus, 8)``), which
fills each pinned batch. With ``host_count > 1`` (the host-sharded mode of
multi-device training) this rank gathers only rows ``[host_index * B / H,
(host_index + 1) * B / H)`` of each global batch, straight into its pinned
batch; the order and the padding are computed globally from the shared
seed, so every rank agrees on the epoch without communicating.
"""

from __future__ import annotations

import math
import pickle
import queue
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from dualvgr_tpu_torch.data.features import FeatureStore, _store_dtype
from dualvgr_tpu_torch.data.vocab import load_vocab
from dualvgr_tpu_torch.utils.trace import count, is_on, span

# string -> id map for legacy pickles that stored category names
# (reference DataLoader.py:29-30)
QUESTION_CATEGORY = {
    "count": 0, "exist": 1, "query_color": 2, "query_size": 3,
    "query_actiontype": 4, "query_actiondir": 5, "query_shape": 6,
    "greater_than": 7, "equal_to": 8, "less_than": 9, "equal_color": 10,
    "equal_size": 11, "equal_actiontype": 12, "equal_actiondir": 13,
    "equal_shape": 14,
}


class Batch(NamedTuple):
    video_idx: np.ndarray  # (B,) int64
    question_idx: np.ndarray  # (B,) int64
    question_category: Optional[np.ndarray]  # (B,) int32 or None
    answer: np.ndarray  # (B,) int32
    appearance_feat: torch.Tensor  # (B, C, F, D) float32 or bfloat16 (transfer_dtype)
    motion_feat: torch.Tensor  # (B, C, D) float32 or bfloat16
    question: np.ndarray  # (B, T) int32
    question_len: np.ndarray  # (B,) int32
    valid: np.ndarray  # (B,) float32 — 0 for padding rows of the final batch


class VideoQADataLoader:
    """Iterable over Batch tuples; one pass per ``__iter__`` call."""

    def __init__(
        self,
        *,
        question_pt: str,
        vocab_json: str,
        appearance_feat: str | FeatureStore,
        motion_feat: str | FeatureStore,
        batch_size: int,
        shuffle: bool,
        # reference-CLI compat (DataLoader.py:165 forked torch workers):
        # the native row gather's thread count (0 = auto)
        num_workers: int = 0,
        train_num: int = 0,
        val_num: int = 0,
        test_num: int = 0,
        seed: int = 666,
        feature_cache_gb: float = 8.0,
        prefetch: int = 2,
        pad_final: bool = True,
        # dtype the feature batches are assembled and sent in ("float32" or
        # "bfloat16", cfg.tpu.transfer_dtype): bfloat16 halves the RAM cache
        # and the host->device bytes per step; the model upcasts on device
        transfer_dtype: str = "float32",
        pin_memory: bool = False,
        # host-sharded loading: this rank's block of each global batch (the
        # rows parallel.process_batch_bounds gives it)
        host_index: int = 0,
        host_count: int = 1,
    ):
        if host_count > 1:
            if batch_size % host_count:
                raise ValueError(f"batch_size {batch_size} not divisible by host_count {host_count}")
            if not pad_final:
                raise ValueError("host-sharded loading requires pad_final")
            if not 0 <= host_index < host_count:
                raise ValueError(f"host_index {host_index} not in [0, {host_count})")
        self.host_index, self.host_count = host_index, host_count
        self.vocab = load_vocab(vocab_json)
        with open(question_pt, "rb") as f:
            obj = pickle.load(f)
        questions = np.asarray(obj["questions"], dtype=np.int32)
        questions_len = np.asarray(obj["questions_len"], dtype=np.int32)
        video_ids = np.asarray(obj["video_ids"], dtype=np.int64)
        q_ids = np.asarray(obj["question_id"], dtype=np.int64)
        answers = np.asarray(obj["answers"], dtype=np.int32)
        self.glove_matrix = obj.get("glove", None)
        categories = obj.get("question_category", None)
        if categories is not None:
            categories = np.asarray(
                [QUESTION_CATEGORY[c] if isinstance(c, str) else int(c) for c in categories],
                dtype=np.int32,
            )

        limit = max(train_num, val_num, test_num)
        if limit > 0:
            questions = questions[:limit]
            questions_len = questions_len[:limit]
            video_ids = video_ids[:limit]
            q_ids = q_ids[:limit]
            answers = answers[:limit]
            if categories is not None:
                categories = categories[:limit]

        self.questions = questions
        self.questions_len = questions_len
        self.video_ids = video_ids
        self.q_ids = q_ids
        self.answers = answers
        self.categories = categories

        self.transfer_dtype = transfer_dtype
        self._feat_dtype = _store_dtype(transfer_dtype)
        self.gather_threads = num_workers if num_workers > 0 else None

        def store(src, name):
            if isinstance(src, FeatureStore):
                return src
            return FeatureStore(src, name, cache_gb=feature_cache_gb, store_dtype=transfer_dtype,
                                n_threads=self.gather_threads)

        self.app_store = store(appearance_feat, "resnet_features")
        self.motion_store = store(motion_feat, "resnext_features")
        self._app_rows = self.app_store.rows_for_video_ids(video_ids)
        self._motion_rows = self.motion_store.rows_for_video_ids(video_ids)

        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_final = pad_final
        self.prefetch = max(prefetch, 1)
        self.pin_memory = pin_memory
        self._rng = np.random.RandomState(seed)
        self._epoch = 0
        # producer-thread lifecycle (one live producer at most): the event
        # lets an abandoned epoch (consumer break/exception) or close()
        # unblock and retire the producer instead of leaving it parked on
        # q.put with the stores in use
        self._producer: Optional[threading.Thread] = None
        self._shutdown = threading.Event()
        self._queue: Optional[queue.Queue] = None

    @property
    def num_samples(self) -> int:
        return len(self.questions)

    def example_batch(self, batch_size: int = 1):
        """Zero-filled (app, motion, question, qlen) at the loader's shapes,
        built from metadata alone: it consumes no RNG shuffle and starts no
        producer thread."""
        c, f, d = self.app_store.shape[1:]
        t = self.questions.shape[1]
        return (
            torch.zeros((batch_size, c, f, d), dtype=self._feat_dtype),
            torch.zeros((batch_size, c, self.motion_store.shape[-1]), dtype=self._feat_dtype),
            np.zeros((batch_size, t), np.int32),
            np.ones((batch_size,), np.int32),
        )

    def __len__(self) -> int:
        # reference overrides DataLoader.__len__ the same way (DataLoader.py:167-168)
        return math.ceil(self.num_samples / self.batch_size)

    def _gather(self, st: FeatureStore, rows: np.ndarray) -> torch.Tensor:
        """``st``'s rows in the transfer dtype, in a pinned tensor with
        ``pin_memory``. A store of another dtype (one handed in) is cast."""
        out = torch.empty((len(rows), *st.shape[1:]), dtype=self._feat_dtype, pin_memory=self.pin_memory)
        if st.out_dtype == self._feat_dtype:
            return st.gather(rows, out=out, n_threads=self.gather_threads)
        return out.copy_(st.gather(rows, n_threads=self.gather_threads))

    def _make_batch(self, idx: np.ndarray, valid: np.ndarray) -> Batch:
        return Batch(
            video_idx=self.video_ids[idx],
            question_idx=self.q_ids[idx],
            question_category=None if self.categories is None else self.categories[idx],
            answer=self.answers[idx],
            appearance_feat=self._gather(self.app_store, self._app_rows[idx]),
            motion_feat=self._gather(self.motion_store, self._motion_rows[idx]),
            question=self.questions[idx],
            question_len=self.questions_len[idx],
            valid=valid,
        )

    def _batch_indices(self):
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        per = bs // self.host_count
        lo = self.host_index * per
        for start in range(0, self.num_samples, bs):
            idx = order[start : start + bs]
            n_valid = len(idx)
            if n_valid < bs and self.pad_final:
                pad = np.full((bs - n_valid,), idx[-1], idx.dtype)
                idx = np.concatenate([idx, pad])
            valid = np.zeros((len(idx),), np.float32)
            valid[:n_valid] = 1.0
            if self.host_count > 1:
                idx, valid = idx[lo : lo + per], valid[lo : lo + per]
            yield idx, valid

    def __iter__(self):
        self._epoch += 1
        self._stop_producer()  # retire any abandoned prior epoch first
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        shutdown = threading.Event()

        def put_checked(item) -> bool:
            """Bounded put that aborts when shutdown is signalled."""
            while not shutdown.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idx, valid in self._batch_indices():
                    if shutdown.is_set():
                        return
                    with span("loader.gather"):
                        batch = self._make_batch(idx, valid)
                    if is_on():
                        count("loader.batches")
                        count("loader.rows", len(idx))
                        count("loader.bytes", batch.appearance_feat.nbytes + batch.motion_feat.nbytes)
                    with span("loader.put"):
                        if not put_checked(batch):
                            return
            except Exception as e:  # handed to the consumer, which re-raises it
                put_checked(_ProducerError(e))
            finally:
                put_checked(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        self._producer, self._shutdown, self._queue = t, shutdown, q
        t.start()
        try:
            while True:
                with span("loader.get"):
                    item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, _ProducerError):
                    raise item.error
                yield item
        finally:
            # runs on normal exhaustion AND on consumer break/exception/GC
            # (GeneratorExit): the producer never outlives its epoch
            self._stop_producer()

    def _stop_producer(self):
        t = self._producer
        if t is None:
            return
        self._shutdown.set()
        # drain so a producer parked on a full queue wakes immediately
        if self._queue is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        t.join(timeout=10.0)
        self._producer = None
        self._queue = None

    def close(self):
        """Stop the producer (joining it) BEFORE closing the files it may
        still be reading."""
        self._stop_producer()
        self.app_store.close()
        self.motion_store.close()


class _ProducerError(NamedTuple):
    error: BaseException
