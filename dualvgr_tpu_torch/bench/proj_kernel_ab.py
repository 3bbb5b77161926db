"""A/B timing of build variants of the BiLSTM's GEMMs: kernel 6 (``csrc/input_proj.cu``, bf16), kernel 7 (``csrc/input_proj_f32.cu``, 3xTF32), kernel 8 (``csrc/wgrad_f32.cu``, 3xTF32) and kernel 9 (``csrc/whh_grad_f32.cu``, 3xTF32).

    python -m dualvgr_tpu_torch.bench.proj_kernel_ab [--kernel 6|7|8|9]
    python -m dualvgr_tpu_torch.bench.proj_kernel_ab --baseline DIR

Needs one CUDA device and ``nvcc``. Each kernel 6 variant is the committed
source with another N-tile width (``kBN``: 256, the committed one, or 128,
with wgmma n128) or another depth of the TMA ring (``kStages``), or, for
timing only, with the epilogue's loops cut to zero steps (the products
without their bias, rounding, staging and stores: the epilogue's share).
They run through ``input_proj_both`` on bf16 x (the product alone, no tanh
pass) at the projection's two shapes, R = 4096 (batch 256) and R = 512
(batch 32), with the probe's inputs (``bench/proj_probe.py``), checked
against the plain version (one bf16 step plus 1e-5) where their results
are meant to be right. Each kernel 7 variant is its committed source with
another raster (``kGroupN``: one group of every N tile, kernel 6's order,
or groups of 4), a 2-stage ring, or, for timing only, without the
promotion's adds or without the epilogue; they run through
``input_proj_f32`` at the train cells' R*T (65,536, 32,768 and 81,920 rows
of D = 2,048 into 2 x 1,536 columns; ``f32_inputs``), each with its error
against the fp64 product (``rel_error``) beside ``torch.baddbmm``'s in fp32
and in TF32, and ``baddbmm``'s time (the plain version: the two products,
the bias broadcast and the flip). Each kernel 8 variant is its committed
source with a 3-stage ring or, for timing only, with the product's launch
cut (the pass alone), the pass's launch cut (the product alone, on a
scratch left by an earlier call) or the promotion's adds cut; they run
through ``input_proj_f32_wgrad`` at the same rows (``wgrad_inputs``),
each with its error against the fp64 product (``fp64_wgrad``) beside the
library SGEMMs' in fp32 and in TF32, interleaved with the plain version
(the two SGEMMs after their transposing copies). Each kernel 9 variant is
its committed source with a 3-stage ring or, for timing only, with the
product and reduce launches cut (hprev's split pass alone) or the pass and
reduce cut (the product alone); they run through ``whh_grad_f32`` at the
appearance BiLSTM's R*T (H 384) and at a question BiLSTM's (256 x 24;
``whh_inputs``), each with its error against the fp64 product
(``fp64_whh``) beside the library SGEMMs' in fp32 and in TF32, interleaved
with the plain version (the two SGEMMs), and then the committed build at
each split count of K (``K9_SPLITS``, the plan's marked) with its time and
error. Every variant is compiled by
``ops/_build.py::build_variants`` and timed with CUDA events, the variants
interleaved (forward order, then reversed) in one process on one card.
Prints each variant's registers and the compiler's warnings, then per
shape its two times in ms and the TFLOP/s of the better one, and the
card's SM clock and power draw (``nvidia-smi``, sampled every 50 ms) while
the committed variant runs back to back for about a second: the tensor
cores' peak scales with the clock, 989 TFLOP/s bf16 and 495 TF32 at 1,830
MHz.

With ``--baseline DIR`` (a checkout of an earlier commit of the repo) it
times kernel 6 as the product on bf16 x and as the tanh pass and product
on fp32 x, at R = 4096 and 512, in DIR's package and in this one, in turns
(baseline, this, this, baseline), one process each
(``bench/timing.py::against_baseline``), with this tree's copy of the
measurement in both: DIR's copy of this tool may not have it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from dualvgr_tpu_torch.bench import proj_probe
from dualvgr_tpu_torch.bench.timing import against_baseline, time_ms
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


K7_SOURCE = "input_proj_f32.cu"
K7_RING, K7_GROUP = "constexpr int kStages = 3;", "constexpr int kGroupN = 8;"
K7_PROMOTION_CUT = ("for (int i = 0; i < kAcc; ++i) acc[i] += d[i];", "for (int i = 0; i < 0; ++i) acc[i] += d[i];")
# name -> ({committed line: variant line}, timing only)
K7_VARIANTS = {
    "committed": ({}, False),
    "one_group": ({K7_GROUP: "constexpr int kGroupN = 1 << 20;"}, False),
    "group4": ({K7_GROUP: "constexpr int kGroupN = 4;"}, False),
    "2stages": ({K7_RING: "constexpr int kStages = 2;"}, False),
    "no_promotion": (dict([K7_PROMOTION_CUT]), True),
    "no_epilogue": (dict(EPILOGUE_CUT), True),
}
# the train cells' rows R*T = R x 16 (msrvtt-qa, msvd-qa and its eval, svqa)
K7_ROWS = (4096, 2048, 5120)
T, D, G = 16, 2048, 1536
H = G // 4  # the BiLSTMs' hidden size


def apply_changes(text: str, changes: dict, source: str = K7_SOURCE) -> str:
    for old, new in changes.items():
        if old not in text:
            raise RuntimeError(f"{source} has no `{old}`: update the variants")
        text = text.replace(old, new)
    return text


def report(name, out):
    regs = [line.split(":")[-1].strip() for line in out.splitlines() if "Used" in line]
    warns = [line.split("ptxas info    : ")[-1].split(" in the function")[0] for line in out.splitlines()
             if "Performance Loss" in line or "warning" in line.lower()]
    print(f"[build] {name}: {'; '.join(regs)}" + "".join(f" | {w}" for w in warns), flush=True)


def build_variants(workdir: Path) -> dict:
    """Compile every kernel 6 variant, all ``nvcc``s at once."""
    text = (_build.CSRC / SOURCE).read_text()
    built = _build.build_variants(SOURCE, {name: {SOURCE: variant_source(text, *variant)}
                                           for name, variant in VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        report(name, out)
    return {name: lib for name, (lib, _) in built.items()}


def f32_inputs(rows, gen, t=T, d=D, g=G):
    """Kernel 7's inputs at R = ``rows`` on ``gen``'s device: x = tanh of
    normal features scaled as dropout at p = 0.15 scales them (the
    appearance encoder's x), each direction's w_ih xavier-uniform and a
    bias of N(0, 0.1^2)."""
    dev = gen.device
    x = torch.tanh(torch.randn(rows, t, d, device=dev, generator=gen) / 0.85)
    lim = (6.0 / (d + g)) ** 0.5
    w_f, w_b = ((torch.rand(g, d, device=dev, generator=gen) * 2 - 1) * lim for _ in range(2))
    b_f, b_b = (torch.randn(g, device=dev, generator=gen) * 0.1 for _ in range(2))
    return x, w_f, b_f, w_b, b_b


def fp64_product(x, w_f, b_f, w_b, b_b):
    """Kernel 7's function in fp64: ``(xf, xb_rev)``."""
    x64 = x.double()
    xf = torch.einsum("rtd,gd->trg", x64, w_f.double()) + b_f.double()
    xb = torch.einsum("rtd,gd->trg", x64, w_b.double()) + b_b.double()
    return xf, xb.flip(0)


def rel_error(got, want):
    """The relative Frobenius error of both directions together."""
    num = sum(torch.linalg.vector_norm(a.double() - b).item() ** 2 for a, b in zip(got, want))
    den = sum(torch.linalg.vector_norm(b).item() ** 2 for b in want)
    return (num / den) ** 0.5


def library_errors(reference, args, want):
    """A plain version's error, run by the library in fp32 and in TF32."""
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        errs = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            errs.append(rel_error(reference(*args), want))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return tuple(errs)


def baddbmm_errors(args, want):
    """``torch.baddbmm``'s (the plain version's) error in fp32 and in TF32."""
    from dualvgr_tpu_torch.ops.proj_kernel import input_proj_f32_reference

    return library_errors(input_proj_f32_reference, args, want)


def wgrad_inputs(rows, gen, t=T, d=D, g=G):
    """Kernel 8's inputs at R = ``rows`` on ``gen``'s device: ``f32_inputs``'s
    x and each direction's dgates (T, R, 4H) of N(0, 1e-6), about the size
    of a train step's."""
    dev = gen.device
    x = torch.tanh(torch.randn(rows, t, d, device=dev, generator=gen) / 0.85)
    dxf, dxb = (torch.randn(t, rows, g, device=dev, generator=gen) * 1e-3 for _ in range(2))
    return x, dxf, dxb


def fp64_wgrad(x, dxf, dxb):
    """Kernel 8's function in fp64: ``(dw_f, dw_b)``, the backward
    direction's dgates in kernel time (its step t with x at T-1-t)."""
    x64 = x.double()
    return (torch.einsum("trg,rtd->gd", dxf.double(), x64),
            torch.einsum("trg,rtd->gd", dxb.double(), x64.flip(1)))


def sgemm_errors(args, want):
    """Kernel 8's plain version's (the library SGEMMs') error in fp32 and
    in TF32."""
    from dualvgr_tpu_torch.ops.proj_kernel import input_proj_f32_wgrad_reference

    return library_errors(input_proj_f32_wgrad_reference, args, want)


K8_SOURCE = "wgrad_f32.cu"
K8_RING = "constexpr int kStages = 4;"
K8_PASS = "x_split_kernel<<<pass_grid, kPassThreads, 0, s>>>("
K8_PRODUCT = "wgrad_f32_kernel<<<grid, kThreads, kSmemBytes, s>>>("
# name -> ({committed line: variant line}, timing only); "library" is no
# build: the plain version, the two SGEMMs after their transposing copies
K8_VARIANTS = {
    "committed": ({}, False),
    "3stages": ({K8_RING: "constexpr int kStages = 3;"}, False),
    "pass_alone": ({K8_PRODUCT: "if (false) " + K8_PRODUCT}, True),
    "product_alone": ({K8_PASS: "if (false) " + K8_PASS}, True),
    "no_promotion": ({K7_PROMOTION_CUT[0]: K7_PROMOTION_CUT[1]}, True),
}


def run_k8(workdir: Path):
    """Kernel 8's variants and the library at the train cells' rows, in
    turns; the cuts say where its time goes."""
    from dualvgr_tpu_torch.ops.proj_kernel import input_proj_f32_wgrad, input_proj_f32_wgrad_reference

    workdir.mkdir()
    text = (_build.CSRC / K8_SOURCE).read_text()
    built = _build.build_variants(K8_SOURCE, {name: {K8_SOURCE: apply_changes(text, changes, K8_SOURCE)}
                                              for name, (changes, _) in K8_VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        report(f"k8 {name}", out)
    names = ["library", *K8_VARIANTS]
    order = names + names[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in K7_ROWS:
        args = wgrad_inputs(rows, gen)
        want = fp64_wgrad(*args)
        e32, e_tf32 = sgemm_errors(args, want)
        times, errs = {}, {}
        for name in order:
            if name == "library":
                times.setdefault(name, []).append(time_ms(lambda: input_proj_f32_wgrad_reference(*args), 5))
                continue
            with _build.using(K8_SOURCE, built[name][0]):
                got = input_proj_f32_wgrad(*args)
                torch.cuda.synchronize()
                if not K8_VARIANTS[name][1]:
                    errs[name] = rel_error(got, want)
                del got
                times.setdefault(name, []).append(time_ms(lambda: input_proj_f32_wgrad(*args), 10))
        flops = 2 * rows * T * D * 2 * G
        with _build.using(K8_SOURCE, built["committed"][0]):
            mhz, watts, _ = clocks_under_load(lambda: input_proj_f32_wgrad(*args))
        print(f"[k8 R{rows}] library SGEMMs error {e32:.3e} (fp32), {e_tf32:.3e} (TF32); committed under load: "
              f"SM clock {mhz:.0f} MHz, power {watts:.1f} W", flush=True)
        for name, ms in times.items():
            note = (" (the two SGEMMs and their transposing copies)" if name == "library"
                    else " (timing only)" if K8_VARIANTS[name][1]
                    else f", error {errs[name]:.3e} ({errs[name] / e32:.2f}x)")
            print(f"[k8 R{rows}] {name}: " + " / ".join(f"{m:.4f}" for m in ms)
                  + f" ms, {3 * flops / min(ms) / 1e9:.1f} TFLOP/s on the tensor cores{note}", flush=True)
        del args, want


def whh_inputs(rows, gen, t=T, h=H):
    """Kernel 9's inputs at R = ``rows`` on ``gen``'s device: hprev (T, R,
    2H) of LSTM states, o * tanh(c) with o uniform in (0, 1) and c normal,
    and each direction's dgates (T, R, 4H) of N(0, 1e-6), about the size of
    a train step's."""
    dev = gen.device
    hprev = torch.tanh(torch.randn(t, rows, 2 * h, device=dev, generator=gen))
    hprev *= torch.rand(t, rows, 2 * h, device=dev, generator=gen)
    dxf, dxb = (torch.randn(t, rows, 4 * h, device=dev, generator=gen) * 1e-3 for _ in range(2))
    return hprev, dxf, dxb


def fp64_whh(hprev, dxf, dxb):
    """Kernel 9's function in fp64: ``(dw_f, dw_b)``, (H, 4H) each."""
    h = hprev.shape[-1] // 2
    h64 = hprev.double()
    return (torch.einsum("trh,trg->hg", h64[..., :h], dxf.double()),
            torch.einsum("trh,trg->hg", h64[..., h:], dxb.double()))


def whh_sgemm_errors(args, want):
    """Kernel 9's plain version's (the library SGEMMs') error in fp32 and
    in TF32."""
    from dualvgr_tpu_torch.ops.whh_grad_kernel import whh_grad_f32_reference

    return library_errors(whh_grad_f32_reference, args, want)


K9_SOURCE = "whh_grad_f32.cu"
K9_RING = "constexpr int kStages = 4;"
K9_PASS = "hprev_split_kernel<<<pass_grid, kPassThreads, 0, s>>>("
K9_PRODUCT = "whh_grad_kernel<<<grid, kThreads, kSmemBytes, s>>>("
K9_REDUCE = "whh_grad_reduce_kernel<<<reduce_grid, kPassThreads, 0, s>>>("
# name -> ({committed line: variant line}, timing only); "library" is no
# build: the plain version, the two SGEMMs
K9_VARIANTS = {
    "committed": ({}, False),
    "3stages": ({K9_RING: "constexpr int kStages = 3;"}, False),
    "pass_alone": ({K9_PRODUCT: "if (false) " + K9_PRODUCT, K9_REDUCE: "if (false) " + K9_REDUCE}, True),
    "product_alone": ({K9_PASS: "if (false) " + K9_PASS, K9_REDUCE: "if (false) " + K9_REDUCE}, True),
}
# (R, T) of the appearance BiLSTM at the train cells and of the question
# BiLSTM at msrvtt-qa's batch (256 questions of 24 tokens), H 384
K9_SHAPES = {"msrvtt-qa": (4096, T), "msvd-qa": (2048, T), "svqa": (5120, T), "question": (256, 24)}
K9_SPLITS = (1, 2, 4, 6, 7, 11, 22, 33)


def run_k9(workdir: Path):
    """Kernel 9's variants and the library at the train cells' appearance
    rows and the question shape, in turns, then the committed build at each
    split count of ``K9_SPLITS`` (the plan's marked); the cuts say where its
    time goes."""
    from dualvgr_tpu_torch.ops import whh_grad_kernel
    from dualvgr_tpu_torch.ops.whh_grad_kernel import whh_grad_f32, whh_grad_f32_reference

    workdir.mkdir()
    text = (_build.CSRC / K9_SOURCE).read_text()
    built = _build.build_variants(K9_SOURCE, {name: {K9_SOURCE: apply_changes(text, changes, K9_SOURCE)}
                                              for name, (changes, _) in K9_VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        report(f"k9 {name}", out)
    names = ["library", *K9_VARIANTS]
    order = names + names[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, (rows, t) in K9_SHAPES.items():
        args = whh_inputs(rows, gen, t=t)
        want = fp64_whh(*args)
        e32, e_tf32 = whh_sgemm_errors(args, want)
        times, errs = {}, {}
        for name in order:
            if name == "library":
                times.setdefault(name, []).append(time_ms(lambda: whh_grad_f32_reference(*args), 5))
                continue
            with _build.using(K9_SOURCE, built[name][0]):
                got = whh_grad_f32(*args)
                torch.cuda.synchronize()
                if not K9_VARIANTS[name][1]:
                    errs[name] = rel_error(got, want)
                del got
                times.setdefault(name, []).append(time_ms(lambda: whh_grad_f32(*args), 10))
        flops = 2 * rows * t * H * 2 * 4 * H
        planned = whh_grad_kernel.whh_grad_plan(rows, t, H, whh_grad_kernel.sm_count(args[0].device))
        with _build.using(K9_SOURCE, built["committed"][0]):
            mhz, watts, _ = clocks_under_load(lambda: whh_grad_f32(*args))
            splits = {}
            for s in sorted({*K9_SPLITS, planned}):
                if s <= t * -(-rows // 32):
                    got = whh_grad_kernel._whh_cuda(*args, splits=s)
                    splits[s] = (time_ms(lambda: whh_grad_kernel._whh_cuda(*args, splits=s), 10), rel_error(got, want))
                    del got
        print(f"[k9 {shape} R{rows} T{t}] library SGEMMs error {e32:.3e} (fp32), {e_tf32:.3e} (TF32); committed "
              f"under load: SM clock {mhz:.0f} MHz, power {watts:.1f} W", flush=True)
        for name, ms in times.items():
            note = (" (the two SGEMMs)" if name == "library"
                    else " (timing only)" if K9_VARIANTS[name][1]
                    else f", error {errs[name]:.3e} ({errs[name] / e32:.2f}x)")
            print(f"[k9 {shape}] {name}: " + " / ".join(f"{m:.4f}" for m in ms)
                  + f" ms, {3 * flops / min(ms) / 1e9:.1f} TFLOP/s on the tensor cores{note}", flush=True)
        print(f"[k9 {shape}] splits (ms, error): " + ", ".join(
            f"{s}{'*' if s == planned else ''}: {ms:.4f}, {err:.3e}" for s, (ms, err) in splits.items())
            + " (* the plan's)", flush=True)
        del args, want


def run_k7(workdir: Path):
    """Kernel 7's variants at the train cells' rows."""
    from dualvgr_tpu_torch.ops.proj_kernel import input_proj_f32, input_proj_f32_reference

    workdir.mkdir()
    text = (_build.CSRC / K7_SOURCE).read_text()
    built = _build.build_variants(K7_SOURCE, {name: {K7_SOURCE: apply_changes(text, changes)}
                                              for name, (changes, _) in K7_VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        report(f"k7 {name}", out)
    order = list(K7_VARIANTS) + list(K7_VARIANTS)[::-1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows in K7_ROWS:
        args = f32_inputs(rows, gen)
        want = fp64_product(*args)
        e32, e_tf32 = baddbmm_errors(args, want)
        lib_ms = time_ms(lambda: input_proj_f32_reference(*args), 5)
        times, errs = {}, {}
        for name in order:
            with _build.using(K7_SOURCE, built[name][0]):
                got = input_proj_f32(*args)
                torch.cuda.synchronize()
                if not K7_VARIANTS[name][1]:
                    errs[name] = rel_error(got, want)
                del got
                times.setdefault(name, []).append(time_ms(lambda: input_proj_f32(*args), 10))
        flops = 2 * rows * T * D * 2 * G
        with _build.using(K7_SOURCE, built["committed"][0]):
            mhz, watts, _ = clocks_under_load(lambda: input_proj_f32(*args))
        print(f"[k7 R{rows}] baddbmm {lib_ms:.3f} ms, error {e32:.3e} (fp32), {e_tf32:.3e} (TF32); committed under "
              f"load: SM clock {mhz:.0f} MHz, power {watts:.1f} W", flush=True)
        for name, ms in times.items():
            note = " (timing only)" if K7_VARIANTS[name][1] else f", error {errs[name]:.3e} ({errs[name] / e32:.2f}x)"
            print(f"[k7 R{rows}] {name}: " + " / ".join(f"{m:.4f}" for m in ms)
                  + f" ms, {flops / min(ms) / 1e9:.1f} TFLOP/s of the product, "
                  + f"{3 * flops / min(ms) / 1e9:.1f} on the tensor cores{note}", flush=True)
        del args, want


def clocks_under_load(fn, seconds=1.0):
    """(median SM clock in MHz, median power draw in W, power limit in W)
    sampled by ``nvidia-smi`` while ``fn`` runs back to back for
    ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader,nounits",
         "-lms", "50"],
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
    return tuple(statistics.median(r[i] for r in rows) for i in range(3))


@torch.no_grad()
def measure():
    """Kernel 6 at both R, on bf16 x and on fp32 x with its tanh pass, in
    the package on the path; prints the ``RESULT`` line."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for rows in ROWS:
        x, w_f, b_f, w_b, b_b = proj_probe.make_inputs(rows, gen)
        x16 = torch.tanh(x).to(torch.bfloat16)
        out[f"k6_bf16_x_R{rows}"] = time_ms(lambda: input_proj_both(x16, w_f, b_f, w_b, b_b, fuse_tanh=False), 50)
        out[f"k6_tanh_R{rows}"] = time_ms(lambda: input_proj_both(x, w_f, b_f, w_b, b_b), 50)
        del x, x16
    print("RESULT " + json.dumps(out), flush=True)


@torch.no_grad()
def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("6", "7", "8", "9"), help="only this kernel's variants")
    ap.add_argument("--baseline", type=Path, help="a checkout of an earlier commit to time kernel 6 against")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("proj_kernel_ab: no CUDA device")
    if args.measure:
        measure()
        return
    print(torch.cuda.get_device_name(0), flush=True)
    if args.baseline:
        against_baseline("dualvgr_tpu_torch.bench.proj_kernel_ab", args.baseline.resolve(), Path(__file__).resolve())
        return
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        if args.kernel in (None, "9"):
            run_k9(Path(tmp) / "k9")
        if args.kernel in (None, "8"):
            run_k8(Path(tmp) / "k8")
        if args.kernel in (None, "7"):
            run_k7(Path(tmp) / "k7")
        if args.kernel in (None, "6"):
            run_k6(Path(tmp) / "k6")


def run_k6(workdir: Path):
    """Kernel 6's variants at both R."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    workdir.mkdir()
    libs = build_variants(workdir)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for rows in ROWS:
        x, w_f, b_f, w_b, b_b = proj_probe.make_inputs(rows, gen)
        x16 = torch.tanh(x).to(torch.bfloat16)
        del x
        args = (x16, w_f, b_f, w_b, b_b)
        want = input_proj_both_reference(*args, fuse_tanh=False)
        times = {}
        for name in order:
            with _build.using(SOURCE, libs[name]):
                got = input_proj_both(*args, fuse_tanh=False)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    steps, _, ok = proj_probe.compare(a, b)
                    if not ok and not VARIANTS[name][2]:
                        raise RuntimeError(f"{name} at R={rows}: {steps:.2f} bf16 steps from the plain version")
                del got
                times.setdefault(name, []).append(time_ms(lambda: input_proj_both(*args, fuse_tanh=False), 20))
        flops = 2 * x16.numel() * 2 * w_f.shape[0]
        with _build.using(SOURCE, libs["committed"]):
            mhz, watts, _ = clocks_under_load(lambda: input_proj_both(*args, fuse_tanh=False))
        print(f"[R{rows}] committed under load: SM clock {mhz:.0f} MHz, power {watts:.1f} W", flush=True)
        for name, ms in times.items():
            note = " (timing only: epilogue cut)" if VARIANTS[name][2] else ""
            print(f"[R{rows}] {name}: " + " / ".join(f"{m:.4f}" for m in ms)
                  + f" ms, {flops / min(ms) / 1e9:.1f} TFLOP/s{note}", flush=True)
        del args, want, x16


if __name__ == "__main__":
    main()
