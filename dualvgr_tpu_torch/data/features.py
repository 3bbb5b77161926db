"""Clip-feature store: id -> row lookups and batched row gathers.

The port's own copy of the JAX package's ``data/features.py``, with the
same artifact contract (reference preprocess/preprocess_features.py:158-198,
DataLoader.py:71-74, 140-147):

* ``{ds}_appearance_feat.h5``: dataset ``resnet_features`` float32
  (N_videos, num_clips, 16, 2048) + ``ids`` int;
* ``{ds}_motion_feat.h5``: dataset ``resnext_features`` float32
  (N_videos, num_clips, 2048) + ``ids``.

Each file is opened once. A file whose STORED bytes fit ``cache_gb`` is
read once into a CPU tensor and every gather is one call of the native
threaded row gather (``data/native.py``, ``n_threads`` threads: the
loader's ``num_workers``), which writes straight into the caller's buffer,
a pinned one on the way to the card; a larger file stays on disk and each
gather is one sorted unique read (h5py needs increasing indices).

``store_dtype="bfloat16"`` keeps the store in bfloat16, cast once with the
native round-to-nearest-even cast chunk by chunk, so the peak host memory
stays about the bf16 size; it halves the cache and the bytes each batch
sends to the card. A file-backed bf16 store casts each batch the same way.
``h5py`` is imported only where a file is opened: a store built in memory
(``FeatureStore.from_array``) needs no h5py.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from dualvgr_tpu_torch.data import native

_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _store_dtype(name: str) -> torch.dtype:
    if name not in _STORE_DTYPES:
        raise ValueError(f"store_dtype must be float32/bfloat16, got {name}")
    return _STORE_DTYPES[name]


def _load_as_bf16(src, rows_per_chunk: int = 256, n_threads: int | None = None) -> torch.Tensor:
    """An fp32 array-like (an h5py dataset, a numpy array or a tensor) as a
    bf16 tensor, cast ``rows_per_chunk`` rows at a time so that the fp32
    copy never exists whole."""
    out = torch.empty(tuple(src.shape), dtype=torch.bfloat16)
    for start in range(0, src.shape[0], rows_per_chunk):
        stop = min(start + rows_per_chunk, src.shape[0])
        chunk = torch.as_tensor(src[start:stop]).contiguous()
        native.cast_f32_to_bf16(chunk, out=out[start:stop], n_threads=n_threads)
    return out


class FeatureStore:
    """One feature file (or array): id -> row lookups + batched row gathers."""

    def __init__(self, path: str, dataset_name: str, cache_gb: float = 8.0,
                 store_dtype: str = "float32", n_threads: int | None = None):
        import h5py

        self.path = path
        self.dataset_name = dataset_name
        # the gather's and the cast's thread count; None = native.default_threads()
        self.n_threads = n_threads
        self._lock = threading.Lock()
        self.out_dtype = _store_dtype(store_dtype)
        with h5py.File(path, "r") as f:
            ids = f["ids"][()]
            dset = f[dataset_name]
            self.shape = tuple(dset.shape)
            self.dtype = dset.dtype  # on-disk dtype (the artifact contract)
            if store_dtype == "bfloat16" and dset.dtype != np.float32:
                raise ValueError(f"bfloat16 store requires float32 on disk, got {dset.dtype}")
            if store_dtype == "float32":
                self.out_dtype = torch.from_numpy(np.empty(0, dset.dtype)).dtype
            stored_bytes = self.out_dtype.itemsize * int(np.prod(dset.shape))
            if stored_bytes > cache_gb * 1e9:
                self._cache = None
            elif store_dtype == "bfloat16":
                self._cache = _load_as_bf16(dset, n_threads=n_threads)
            else:
                self._cache = torch.from_numpy(dset[()])
        # {str(video_id): row} exactly like the reference (DataLoader.py:141-147)
        self.id_to_index = {str(i): idx for idx, i in enumerate(ids)}
        self._file = None if self._cache is not None else h5py.File(path, "r")

    @classmethod
    def from_array(cls, ids, feats, dataset_name: str, store_dtype: str = "float32",
                   n_threads: int | None = None) -> "FeatureStore":
        """A store held in memory from the start: ``feats`` (N, ...) float32
        (numpy or a CPU tensor) with ``ids`` (N,), taking the same path as a
        cached file. ``feats`` is kept without a copy when it already is a
        CPU tensor of the store's dtype."""
        self = cls.__new__(cls)
        self.path, self.dataset_name, self._lock, self._file = None, dataset_name, threading.Lock(), None
        self.n_threads = n_threads
        self.out_dtype = _store_dtype(store_dtype)
        feats = torch.as_tensor(feats)
        if feats.dtype != torch.float32:
            raise ValueError(f"from_array takes float32 features, got {feats.dtype}")
        self.shape = tuple(feats.shape)
        self.dtype = np.dtype(np.float32)
        self._cache = (_load_as_bf16(feats, n_threads=n_threads) if store_dtype == "bfloat16"
                       else feats.cpu().contiguous())
        ids = np.asarray(ids)
        if len(ids) != self.shape[0]:
            raise ValueError(f"{len(ids)} ids for {self.shape[0]} feature rows")
        self.id_to_index = {str(i): idx for idx, i in enumerate(ids)}
        return self

    @property
    def cached(self) -> bool:
        return self._cache is not None

    def rows_for_video_ids(self, video_ids) -> np.ndarray:
        return np.asarray([self.id_to_index[str(int(v))] for v in video_ids], dtype=np.int64)

    def row(self, video_id) -> torch.Tensor:
        """One video's features: a view of the cache (no copy, and none of
        torch's intra-op threads, which a server's thread per request would
        start anew each time), or one read from the file. Raises KeyError
        for an unknown id."""
        idx = self.id_to_index[str(int(video_id))]
        if self._cache is not None:
            return self._cache[idx]
        return self.gather(np.array([idx]))[0]

    def gather(self, rows, out: torch.Tensor | None = None, n_threads: int | None = None) -> torch.Tensor:
        """The feature rows ``rows`` (duplicates allowed, any order) as a CPU
        tensor of the store's dtype, written into ``out`` when given, with
        ``n_threads`` threads (None: the store's ``n_threads``)."""
        n_threads = n_threads or self.n_threads
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        if self._cache is not None:
            return native.gather_rows(self._cache, rows, out=out, n_threads=n_threads)
        uniq, inverse = np.unique(rows, return_inverse=True)
        with self._lock:
            block = self._file[self.dataset_name][uniq]  # sorted unique read
        block = torch.from_numpy(block)
        if block.dtype != self.out_dtype:  # file-backed bfloat16: cast per batch
            block = native.cast_f32_to_bf16(block, n_threads=n_threads)
        return native.gather_rows(block, inverse, out=out, n_threads=n_threads)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None
