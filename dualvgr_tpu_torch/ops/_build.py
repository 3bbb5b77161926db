"""Builds the port's CUDA sources (``csrc/*.cu``) at first use.

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which the kernel modules load with
``ctypes``. The libraries go to ``dualvgr_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source, the headers of ``csrc/`` and
the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as it is. ``build`` starts
one ``nvcc`` per source, all together, and waits for them.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("bilstm_recurrence.cu", "gat_cycle.cu", "bilstm_train_fwd.cu", "bilstm_train_bwd.cu",
           "input_proj.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by a hash
    of the source, every header in ``csrc/`` (a source may include any of
    them) and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``s at once.

    Returns ``{source: ptxas report}`` for the sources compiled now (the
    registers, shared memory and spills of each kernel). Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for src in sources:
        target = library_path(src)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[src] = (proc, tmp, target)
    reports, failed = {}, []
    for src, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {src} exited {proc.returncode}:\n{out}")
            continue
        os.replace(tmp, target)
        reports[src] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build((source,))
            lib = _libs[source] = ctypes.CDLL(str(library_path(source)))
        return lib


def build_all() -> tuple[float, dict[str, str]]:
    """Build every kernel of the port in parallel; returns the seconds taken
    and the compiler's report of each source compiled now."""
    t0 = time.perf_counter()
    with _lock:
        reports = build(SOURCES)
    return time.perf_counter() - t0, reports
