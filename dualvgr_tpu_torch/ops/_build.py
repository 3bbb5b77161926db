"""Builds the port's CUDA sources (``csrc/*.cu``) at first use, and declares their entries.

Each source is compiled on its own by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, which the kernel modules call through
``ctypes``. The libraries go to ``dualvgr_tpu_torch/_build/`` (listed in
.gitignore), named by a hash of the source, the headers of ``csrc/`` and
the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as it is. ``build`` starts
one ``nvcc`` per source, all together, and waits for them.

``ENTRIES`` declares every ``extern "C"`` entry of the sources once;
``load`` applies it to a library as it loads it, and ``entry`` hands out
a declared entry by name. The A/B tools build variants of a source from
text (``build_variants``, the same command line) and put one in the
source's place for a while (``using``).

Nothing here runs at import: the CPU tests import every module of the
port, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# every ``extern "C"`` entry of each source: (return type, argument types)
# in the order of its C signature; a launch takes the stream last
ENTRIES = {
    "bilstm_recurrence.cu": {
        "bilstm_recurrence_launch": (_I, (_P,) * 7 + (_I,) * 8 + (_P,)),
        "bilstm_recurrence_active_clusters": (_I, (_I,) * 4),
        "bilstm_recurrence_smem_bytes": (_I, (_I,) * 3),
    },
    "gat_cycle.cu": {
        "gat_cycle_smem_bytes": (_I, (_I,) * 8),
        "gat_cycle_active_clusters": (_I, (_I,) * 8),
        "gat_cycle_launch": (_I, (_P,) * 2 + (_LL,) * 3 + (_P,) * 14 + (_I,) * 8 + (_P,)),
    },
    "bilstm_train_fwd.cu": {
        "bilstm_train_fwd_launch": (_I, (_P,) * 10 + (_I,) * 8 + (_P,)),
        "bilstm_train_fwd_active_clusters": (_I, (_I,) * 4),
        "bilstm_train_fwd_smem_bytes": (_I, (_I,) * 3),
    },
    "bilstm_train_bwd.cu": {
        "bilstm_train_bwd_launch": (_I, (_P,) * 9 + (_I,) * 7 + (_P,)),
        "bilstm_train_bwd_active_clusters": (_I, (_I,) * 3),
        "bilstm_train_bwd_smem_bytes": (_I, (_I,) * 3),
    },
    "input_proj.cu": {
        "input_proj_launch": (_I, (_P,) * 5 + (_I,) * 7 + (_P,)),
        "input_proj_smem_bytes": (_I, ()),
        "tanh_to_bf16_launch": (_I, (_P, _P, _LL, _P)),
    },
    "input_proj_f32.cu": {
        "input_proj_f32_launch": (_I, (_P,) * 8 + (_I,) * 4 + (_P,)),
        "input_proj_f32_smem_bytes": (_I, ()),
    },
    "wgrad_f32.cu": {
        "wgrad_f32_launch": (_I, (_P,) * 6 + (_I,) * 5 + (_P,)),
        "wgrad_f32_smem_bytes": (_I, ()),
    },
    "whh_grad_f32.cu": {
        "whh_grad_f32_launch": (_I, (_P,) * 7 + (_I,) * 5 + (_P,)),
        "whh_grad_f32_smem_bytes": (_I, ()),
    },
}
SOURCES = tuple(ENTRIES)
_SOURCE_OF = {name: source for source, entries in ENTRIES.items() for name in entries}

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


def _compile(jobs: dict) -> tuple[dict[str, str], list[str]]:
    """One ``nvcc`` for each ``{key: (source file, library)}`` of ``jobs``,
    all at once, headers found beside the file, then in ``csrc/``. Returns
    the compiler's report of each job that built and the failures."""
    nvcc = _nvcc()
    procs = {key: subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for key, (src, out) in jobs.items()}
    reports, failed = {}, []
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {key} exited {proc.returncode}:\n{out}")
        else:
            reports[key] = out
    return reports, failed


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc``s at once.

    Returns ``{source: ptxas report}`` for the sources compiled now (the
    registers, shared memory and spills of each kernel). Raises with the
    compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {src: (CSRC / src, library_path(src).with_suffix(f".{os.getpid()}.tmp"))
            for src in sources if not library_path(src).exists()}
    reports, failed = _compile(jobs)
    for src in reports:
        os.replace(jobs[src][1], library_path(src))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def _declare(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    for name, (restype, argtypes) in ENTRIES[source].items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed, its
    entries declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build((source,))
            lib = _libs[source] = _declare(ctypes.CDLL(str(library_path(source))), source)
        return lib


def entry(name: str):
    """The declared entry ``name`` of the library in its source's place."""
    return getattr(load(_SOURCE_OF[name]), name)


def build_all() -> tuple[float, dict[str, str]]:
    """Build every kernel of the port in parallel; returns the seconds taken
    and the compiler's report of each source compiled now."""
    t0 = time.perf_counter()
    with _lock:
        reports = build(SOURCES)
    return time.perf_counter() - t0, reports


def build_variants(source: str, variants: dict, workdir) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile variants of ``csrc/<source>`` as ``build`` compiles it, all
    ``nvcc``s at once, each in its own directory under ``workdir``:
    ``variants`` maps a name to the files it changes, ``{file name: text}``
    (the source, or a header of ``csrc/``, which the source then includes
    in place of the committed one). Returns ``{name: (library, ptxas
    report)}``; raises with the compiler's output if any build fails."""
    jobs = {}
    for name, files in variants.items():
        d = Path(workdir) / name
        d.mkdir()
        for fname, text in {source: (CSRC / source).read_text(), **files}.items():
            (d / fname).write_text(text)
        jobs[name] = (d / source, d / "lib.so")
    reports, failed = _compile(jobs)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: (ctypes.CDLL(str(out)), reports[name]) for name, (_, out) in jobs.items()}


@contextlib.contextmanager
def using(source: str, lib: ctypes.CDLL):
    """Put ``lib`` (a variant from ``build_variants``) in ``csrc/<source>``'s
    place, declared as ``load`` declares it, so that the wrappers launch it
    in the body; the library in place before comes back on exit."""
    with _lock:
        before = _libs.get(source)
        _libs[source] = _declare(lib, source)
    try:
        yield lib
    finally:
        with _lock:
            if before is None:
                _libs.pop(source, None)
            else:
                _libs[source] = before
