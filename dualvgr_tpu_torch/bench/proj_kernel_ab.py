"""A/B timing of build variants of the projection GEMM (``csrc/input_proj.cu``).

    python -m dualvgr_tpu_torch.bench.proj_kernel_ab

Needs one CUDA device and ``nvcc``. Each variant is the committed source
with another N-tile width (``kBN``: 256, the committed one, or 128, with
wgmma n128) or another depth of the TMA ring (``kStages``), or, for timing
only, with the epilogue's loops cut to zero steps (the products without
their bias, rounding, staging and stores: the epilogue's share). Every variant
is compiled as ``ops/_build.py`` compiles the source, run through
``input_proj_both`` on bf16 x (the product alone, no tanh pass) at the
projection's two shapes, R = 4096 (batch 256) and R = 512 (batch 32), with
the probe's inputs (``bench/proj_probe.py``), checked against the plain
version (one bf16 step plus 1e-5) where its results are meant to be
right, and timed with CUDA events, the variants
interleaved (forward order, then reversed) in one process on one card.
Prints each variant's registers, then per shape its two times in ms and
the TFLOP/s of the better one, and the card's SM clock and power draw
(``nvidia-smi``, sampled every 50 ms) while the committed variant runs
back to back for about a second: the tensor cores' peak scales with the
clock, 989 TFLOP/s at 1,830 MHz.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from dualvgr_tpu_torch.bench import proj_probe
from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.proj_kernel import input_proj_both, input_proj_both_reference

SOURCE = "input_proj.cu"
TILE, RING = "constexpr int kBM = 128, kBN = 256, kBK = 64;", "constexpr int kStages = 3;"
# the epilogue's two loops, cut to zero steps: staging the tile, storing it
EPILOGUE_CUT = (("for (int j = 0; j < kBN / 8; ++j) {", "for (int j = 0; j < 0; ++j) {"),
                ("for (int n = n0; n < n_end;) {", "for (int n = n0; n < n0;) {"))
# name -> (N-tile width, ring depth, epilogue cut); the ring and the staged
# output tile share the 227 KB of shared memory: 3 stages of a 256-wide
# tile or 5 of a 128-wide one
VARIANTS = {
    "committed": (256, 3, False), "n256_2stages": (256, 2, False), "n128_5stages": (128, 5, False),
    "no_epilogue": (256, 3, True),
}
ROWS = (4096, 512)


def variant_source(text: str, bn: int, stages: int, cut: bool) -> str:
    for line in (TILE, RING, *(old for old, _ in EPILOGUE_CUT)):
        if line not in text:
            raise RuntimeError(f"{SOURCE} has no `{line}`: update the variants")
    text = (text.replace(TILE, TILE.replace("kBN = 256", f"kBN = {bn}"))
            .replace(RING, RING.replace("= 3", f"= {stages}")))
    for old, new in EPILOGUE_CUT if cut else ():
        text = text.replace(old, new)
    return text


def build_variants(workdir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every variant, all ``nvcc``s at once."""
    text = (_build.CSRC / SOURCE).read_text()
    procs = {}
    for name, (bn, stages, cut) in VARIANTS.items():
        src = workdir / f"{name}.cu"
        src.write_text(variant_source(text, bn, stages, cut))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(workdir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} exited {proc.returncode}:\n{out}")
        regs = [line.split(":")[-1].strip() for line in out.splitlines() if "Used" in line]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(workdir / f"{name}.so"))
    return libs


def clocks_under_load(fn, seconds=1.0):
    """(median SM clock in MHz, median power draw in W) sampled by
    ``nvidia-smi`` while ``fn`` runs back to back for ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines() if line.strip()]
    rows = rows[len(rows) // 4:]  # past the ramp
    return statistics.median(r[0] for r in rows), statistics.median(r[1] for r in rows)


@torch.no_grad()
def main():
    if not torch.cuda.is_available():
        raise SystemExit("proj_kernel_ab: no CUDA device")
    print(torch.cuda.get_device_name(0), flush=True)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(Path(tmp))
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for rows in ROWS:
            x, w_f, b_f, w_b, b_b = proj_probe.make_inputs(rows, gen)
            x16 = torch.tanh(x).to(torch.bfloat16)
            del x
            args = (x16, w_f, b_f, w_b, b_b)
            want = input_proj_both_reference(*args, fuse_tanh=False)
            times = {}
            for name in order:
                # the wrapper loads its library through _build; hand it the variant's
                _build._libs[SOURCE] = libs[name]
                got = input_proj_both(*args, fuse_tanh=False)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    steps, _, ok = proj_probe.compare(a, b)
                    if not ok and not VARIANTS[name][2]:
                        raise RuntimeError(f"{name} at R={rows}: {steps:.2f} bf16 steps from the plain version")
                del got
                times.setdefault(name, []).append(
                    proj_probe.time_ms(lambda: input_proj_both(*args, fuse_tanh=False), 20))
            flops = 2 * x16.numel() * 2 * w_f.shape[0]
            _build._libs[SOURCE] = libs["committed"]
            mhz, watts = clocks_under_load(lambda: input_proj_both(*args, fuse_tanh=False))
            print(f"[R{rows}] committed under load: SM clock {mhz:.0f} MHz, power {watts:.1f} W", flush=True)
            for name, ms in times.items():
                note = " (timing only: epilogue cut)" if VARIANTS[name][2] else ""
                print(f"[R{rows}] {name}: " + " / ".join(f"{m:.4f}" for m in ms)
                      + f" ms, {flops / min(ms) / 1e9:.1f} TFLOP/s{note}", flush=True)
            del args, want, x16
        _build._libs.pop(SOURCE, None)


if __name__ == "__main__":
    main()
