"""The native host data path: a threaded row gather and bf16 cast (_gather.cpp).

The port's counterpart of the JAX package's ``data/native.py``. The C++
source is compiled with ``g++`` at first use into ``dualvgr_tpu_torch/
_build/`` (listed in .gitignore), named by a hash of the source and the
flags, and loaded with ``ctypes``; ctypes releases the interpreter lock
for the call, so the loader's producer thread gathers while the main
thread drives the card. Two functions:

    gather_rows(src, rows, out=None, n_threads=None) -> torch.Tensor
    cast_f32_to_bf16(src, out=None, n_threads=None) -> torch.Tensor

Both take CPU tensors and write through ``data_ptr()``: the gather straight
into the caller's ``out`` (the pinned batch tensor), the cast into a
``torch.bfloat16`` tensor through its int16 view. A failed build or
``dlopen`` raises with the compiler's output; nothing falls back.
``torch.index_select`` is the gather's plain version (the tests and
``chip_smoke.py`` hold the two equal).

The cast rounds to nearest even on finite values (a carry may round up to
inf) and keeps a NaN's sign and payload, quieted, as ml_dtypes and XLA do;
``Tensor.to(torch.bfloat16)`` writes every NaN as 0x7FC0 instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "_gather.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir) / f"_gather-{digest}.so"


def build(cxx: str = "g++", build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``_gather.cpp`` into ``build_dir`` unless its library is
    there; returns its path. Raises RuntimeError with the compiler's output
    (or the reason it did not start) when the build fails."""
    target = library_path(build_dir)
    if target.exists():
        return target
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native gather: could not run {cxx!r}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native gather: {' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, target)  # atomic: concurrent builds each write their own tmp file
    return target


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gather_rows.restype = ctypes.c_int
    lib.gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.cast_f32_bf16.restype = ctypes.c_int
    lib.cast_f32_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once a process)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _declare(ctypes.CDLL(str(path)))
            except OSError as e:
                raise RuntimeError(f"native gather: dlopen of {path} failed: {e}") from e
        return _lib


def default_threads() -> int:
    return min(os.cpu_count() or 1, 8)


def _check_cpu_contiguous(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous CPU tensor, got {t.device} contiguous={t.is_contiguous()}")


def gather_rows(src: torch.Tensor, rows, out: torch.Tensor | None = None,
                n_threads: int | None = None) -> torch.Tensor:
    """``src[rows]`` (duplicates allowed, any order) with ``n_threads``
    threads (None: ``default_threads()``), written into ``out`` when given.
    Raises IndexError for a row out of range."""
    _check_cpu_contiguous("src", src)
    rows64 = np.ascontiguousarray(rows, dtype=np.int64)
    if rows64.ndim != 1:
        raise ValueError(f"rows must be 1-d, got shape {rows64.shape}")
    shape = (len(rows64), *src.shape[1:])
    if out is None:
        out = torch.empty(shape, dtype=src.dtype)
    _check_cpu_contiguous("out", out)
    if tuple(out.shape) != shape or out.dtype != src.dtype:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, want {shape} {src.dtype}")
    if len(rows64) == 0:
        return out
    row_bytes = src.element_size() * int(np.prod(src.shape[1:], dtype=np.int64))
    rc = load().gather_rows(src.data_ptr(), src.shape[0], row_bytes, rows64.ctypes.data, len(rows64),
                            out.data_ptr(), int(n_threads or default_threads()))
    if rc != 0:
        raise IndexError(f"gather_rows: a row index out of range [0, {src.shape[0]})")
    return out


def gather_rows_reference(src: torch.Tensor, rows, out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of ``gather_rows``: one ``torch.index_select``."""
    idx = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int64))
    if out is None:
        return torch.index_select(src, 0, idx)
    return torch.index_select(src, 0, idx, out=out)


def cast_f32_to_bf16(src: torch.Tensor, out: torch.Tensor | None = None,
                     n_threads: int | None = None) -> torch.Tensor:
    """Round-to-nearest-even float32 -> bfloat16 of ``src`` (NaNs keep
    their sign and payload), written into ``out`` when given."""
    _check_cpu_contiguous("src", src)
    if src.dtype != torch.float32:
        raise TypeError(f"cast_f32_to_bf16 takes float32, got {src.dtype}")
    if out is None:
        out = torch.empty(src.shape, dtype=torch.bfloat16)
    _check_cpu_contiguous("out", out)
    if out.shape != src.shape or out.dtype != torch.bfloat16:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, want {tuple(src.shape)} bfloat16")
    if src.numel():
        load().cast_f32_bf16(src.data_ptr(), out.view(torch.int16).data_ptr(), src.numel(),
                             int(n_threads or default_threads()))
    return out
