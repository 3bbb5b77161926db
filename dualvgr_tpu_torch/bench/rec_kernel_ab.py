"""A/B timing of build variants of the cluster recurrence (kernel 1).

    python -m dualvgr_tpu_torch.bench.rec_kernel_ab

Needs one CUDA device and ``nvcc``. Each variant is
``csrc/bilstm_recurrence.cu`` built against the committed
``csrc/bilstm_cluster.cuh`` with another register tile for the product (4
rows x 12 columns a thread instead of 8 x 6), its K split over 4 warps of
a 128-thread CTA instead of 8 of 256, or its k loop not unrolled (the
committed source unrolls it by 2), or, for timing only, with a part of
the step cut: the h exchange (no distributed shared memory copies, and no
bytes waited for), the product, or the cell update's arithmetic. Every variant
is compiled by ``ops/_build.py::build_variants``, run through the
port's wrapper at the three shapes of the flagship forward on seeded
random gates (the appearance encoder: T 16, R 4096, unmasked, final only;
the question encoders: T 24, R 256, lengths 4..24, with outputs and final
only; and the appearance shape on the same gates rounded to bf16), H 384,
checked against the plain version (1e-4; one bf16 step beyond that for
bf16 outputs) where its results are meant to be right, and timed with
CUDA events, the variants interleaved (forward order, then reversed) in
one process on one card. Prints each variant's registers, the plan, and
per shape its two times in ms; then the card's SM clock, power draw and
power limit (``nvidia-smi``, every 50 ms) while the committed variant runs
the appearance shape back to back for about a second. fp32, TF32 off.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from dualvgr_tpu_torch.bench.proj_kernel_ab import clocks_under_load
from dualvgr_tpu_torch.bench.proj_probe import compare
from dualvgr_tpu_torch.bench.timing import time_ms
from dualvgr_tpu_torch.ops import _build, lstm_kernel
from dualvgr_tpu_torch.ops.lstm_kernel import bilstm_recurrence, bilstm_recurrence_reference

SOURCE, HEADER = "bilstm_recurrence.cu", "bilstm_cluster.cuh"
ROWS = "constexpr int kRowsPerThread = 8;"
LANES = "constexpr int kRowLanes = 2, kColLanes = 32 / kRowLanes;"
THREADS = "constexpr int kThreads = 256;"
PUSH = "for (int i = threadIdx.x; i < cs; i += kThreads)"
BYTES = "const uint32_t step_bytes = kRows * units * 4 * ((H + units - 1) / units);"
PRODUCT = "for (int k = k0; k < kend; k += 4) {"
UNROLL = "#pragma unroll 2\n      for (int k = k0;"
CELL = "if (valid) {"
CUTS = {
    "exchange": ((PUSH, PUSH.replace("i < cs", "i < 0 * cs")), (BYTES, BYTES.replace("kRows *", "0 *"))),
    "product": ((PRODUCT, PRODUCT.replace("k < kend", "k < k0")),),
    "unroll1": ((UNROLL, UNROLL.replace("unroll 2", "unroll 1")),),
    # the cell update's arithmetic skipped (h and c stay zero, the gates unread)
    "cell": ((CELL, "if (false) {"),),
}
# name -> (row lanes, rows per thread, threads, what is changed): a warp
# of row lanes x 32 / row lanes column lanes, a thread rows per thread x
# 96 / (32 / row lanes) columns, a tile of 16 rows, the product's K split
# over threads / 32 warps; only the cuts "exchange", "product" and "cell"
# give wrong results
VARIANTS = {
    "committed": (2, 8, 256, None), "r4c12": (4, 4, 256, None), "k_split4": (2, 8, 128, None),
    "k_unroll1": (2, 8, 256, "unroll1"), "no_exchange": (2, 8, 256, "exchange"),
    "no_product": (2, 8, 256, "product"), "no_cell_update": (2, 8, 256, "cell"),
}
TIMING_ONLY = ("exchange", "product", "cell")
H = 384


def variant_header(text: str, row_lanes: int, rows_per_thread: int, threads: int, cut) -> str:
    for line in (ROWS, LANES, THREADS, PUSH, BYTES, PRODUCT, UNROLL, CELL):
        if line not in text:
            raise RuntimeError(f"{HEADER} has no `{line}`: update the variants")
    text = (text.replace(ROWS, ROWS.replace("= 8", f"= {rows_per_thread}"))
            .replace(LANES, LANES.replace("= 2,", f"= {row_lanes},"))
            .replace(THREADS, THREADS.replace("256", str(threads))))
    for old, new in CUTS[cut] if cut else ():
        text = text.replace(old, new)
    return text


def build_variants(workdir: Path) -> dict:
    """Compile every variant, all ``nvcc``s at once, each with its copy of
    the header."""
    header = (_build.CSRC / HEADER).read_text()
    built = _build.build_variants(SOURCE, {name: {HEADER: variant_header(header, *variant)}
                                           for name, variant in VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        regs = [line.split(":")[-1].strip() for line in out.splitlines() if "Used" in line]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def cases(gen):
    """(name, args, with_outputs) at the three shapes of the flagship forward."""
    dev = gen.device
    g = 4 * H
    w = [torch.randn((H, g), generator=gen, device=dev) * 0.05 for _ in range(2)]
    app = [torch.randn((16, 4096, g), generator=gen, device=dev) for _ in range(2)]
    yield "appearance", (*app, *w, None), False
    yield "appearance_bf16", (*(a.to(torch.bfloat16) for a in app), *w, None), False
    del app
    q = [torch.randn((24, 256, g), generator=gen, device=dev) for _ in range(2)]
    lens = torch.randint(4, 25, (256,), generator=gen, device=dev, dtype=torch.int32)
    yield "question_outputs", (*q, *w, lens), True
    yield "question_final", (*q, *w, lens), False


@torch.no_grad()
def main():
    if not torch.cuda.is_available():
        raise SystemExit("rec_kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(Path(tmp))
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for shape, args, outs in cases(torch.Generator(device="cuda").manual_seed(0)):
            with _build.using(SOURCE, libs["committed"]):
                plan = lstm_kernel.launch_plan("bilstm_recurrence", args[0].shape[1], H,
                                               lstm_kernel.gate_dtype_code("gates", args[0]))
            print(f"[{shape}] plan: cluster {plan.cluster}, clusters {plan.clusters}, idle SMs "
                  f"{sms - plan.cluster * plan.clusters}, rows per tile {plan.rows_per_tile}, items per "
                  f"cluster {plan.tiles_per_cluster}", flush=True)
            want = bilstm_recurrence_reference(*args, with_outputs=outs)
            want = want if outs else (want,)
            times = {}
            for name in order:
                with _build.using(SOURCE, libs[name]):
                    got = bilstm_recurrence(*args, with_outputs=outs)
                    torch.cuda.synchronize()
                    got = got if outs else (got,)
                    # fp32 outputs within 1e-4; bf16 ones within one bf16 step beyond that
                    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
                    ok = all(compare(a, b, 1e-4)[2] if a.dtype == torch.bfloat16
                             else (a - b).abs().max().item() <= 1e-4 for a, b in zip(got, want))
                    if VARIANTS[name][3] not in TIMING_ONLY and not ok:
                        raise RuntimeError(f"{name} at {shape}: max abs err {err:.3e} against the plain version")
                    del got
                    times.setdefault(name, []).append(
                        time_ms(lambda: bilstm_recurrence(*args, with_outputs=outs), 10))
            for name, ms in times.items():
                note = f" (timing only: {VARIANTS[name][3]} cut)" if VARIANTS[name][3] in TIMING_ONLY else ""
                print(f"[{shape}] {name}: " + " / ".join(f"{m:.4f}" for m in ms) + f" ms{note}", flush=True)
            if shape == "appearance":
                with _build.using(SOURCE, libs["committed"]):
                    mhz, watts, limit = clocks_under_load(lambda: bilstm_recurrence(*args, with_outputs=outs))
                print(f"[{shape}] committed under load: SM clock {mhz:.0f} MHz, power {watts:.1f} W of "
                      f"{limit:.1f} W", flush=True)
            del want


if __name__ == "__main__":
    main()
