"""A/B timing of kernel 2 (``csrc/gat_cycle.cu``), the fused graph cycle.

    python -m dualvgr_tpu_torch.bench.gat_kernel_ab
    python -m dualvgr_tpu_torch.bench.gat_kernel_ab --baseline DIR

Needs one CUDA device and ``nvcc``. Without ``--baseline`` it builds the
committed source, two build variants (3-deep rings; 16-row k-chunks) and
timing-only cuts of it, all ``nvcc``s at once, through
``ops/_build.py::build_variants``: the four products cut (their chunk loop runs no
chunk, so Wh is the bias and the rest stays live), the products' FMAs
cut (the chunks still stream through shared memory), the attention cut
(no logits, softmax or aggregation: common and spec are Wh) and the
cluster's exchange of partial scores cut (every CTA reads its own in
place of the other CTAs'). It runs each through the port's wrapper, with
the card's plan, at B in {256, 32} and N in {8, 16, 20}, D = 768, 4
heads, seeded random inputs with one score per clip (a stride-0 view, as
the model passes it); a variant whose shared memory the plan overruns is
reported and skipped. The committed build and the variants are checked
against the plain version (1e-3 x max(1, max|ref|)); every build is timed
with CUDA events, interleaved (forward order, then reversed) in one
process on one card, and each cut is printed beside what it leaves of the
committed time.

With ``--baseline DIR`` (a checkout of an earlier commit of the repo) it
runs the measurement of DIR's copy of this script in DIR's package and this
one's here, in turns (baseline, this, this, baseline), one process each on
the same card (``bench/timing.py::against_baseline``): kernel 2 at the
same shapes and inputs, and the flagship eval forward at batch 256 in fp32
and bf16. It prints each time per run and this tree's mean against the
baseline's. fp32, TF32 off.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from dualvgr_tpu_torch.bench.timing import against_baseline, time_ms
from dualvgr_tpu_torch.ops import _build

SOURCE = "gat_cycle.cu"
# name -> the replacements that make it; the cuts ("no_*") are timing only
VARIANTS = {
    "committed": (),
    "stages3": (("constexpr int kStages = 2;", "constexpr int kStages = 3;"),),
    "kc16": (("constexpr int kKC = 32;", "constexpr int kKC = 16;"),),
    "no_products": (("for (int j = 0; j < nchunks; ++j) {", "for (int j = 0; j < 0; ++j) {"),),
    "no_fma": (("if (ln.on) compute(", "if (false) compute("),),
    "no_attention": (("attention(p, s, sm, g, v0, tbr, rank * s.hpc);", ";"),),
    "no_exchange": (("return cg::this_cluster().map_shared_rank(p, rank);", "return p;"),),
}
D, HEADS = 768, 4
SHAPES = [(b, n) for b in (256, 32) for n in (8, 16, 20)]
FLAGSHIP = dict(vision_dim=2048, module_dim=768, word_dim=300, question_vocab_size=8000,
                num_answers=4000, num_of_nodes=16, graph_layers=1, unit_layers=1)
BATCH, CLIPS, FRAMES, QLEN = 256, 16, 16, 24


def variant_source(text: str, cuts) -> str:
    for old, new in cuts:
        if old not in text:
            raise RuntimeError(f"{SOURCE} has no `{old}`: update the variants")
        text = text.replace(old, new)
    return text


def build_variants(workdir: Path) -> dict:
    """Compile every variant, all ``nvcc``s at once."""
    text = (_build.CSRC / SOURCE).read_text()
    built = _build.build_variants(SOURCE, {name: {SOURCE: variant_source(text, cuts)}
                                           for name, cuts in VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        regs = [line.split(":")[-1].strip() for line in out.splitlines() if "Used" in line or "spill" in line]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def cases(gen):
    """(name, h, scores, weights) at each shape of SHAPES."""
    dev = gen.device
    hd = D // HEADS

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev) / shape[0] ** 0.5

    args = (w(D, D), w(D), w(HEADS, 2 * hd), w(HEADS), w(D, D), w(D), w(HEADS, 2 * hd), w(HEADS),
            w(D, D), w(D), w(D, 1))
    for b, n in SHAPES:
        h = torch.randn((b, n, D), generator=gen, device=dev)
        scores = torch.rand((b, n, 1), generator=gen, device=dev).expand(b, n, hd)
        yield f"B{b} N{n}", h, scores, args


@torch.no_grad()
def measure():
    """This process's package: kernel 2 per shape and the eval forwards,
    printed as one ``RESULT`` JSON line."""
    from dualvgr_tpu_torch import build_model
    from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    times = {}
    for name, h, scores, args in cases(torch.Generator(device="cuda").manual_seed(0)):
        times[f"kernel 2 {name}"] = time_ms(lambda: gat_cycle(h, scores, *args), 20)
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = build_model(seed=0, **FLAGSHIP)
    app = torch.randn((BATCH, CLIPS, FRAMES, FLAGSHIP["vision_dim"]), generator=gen, device="cuda")
    mot = torch.randn((BATCH, CLIPS, FLAGSHIP["vision_dim"]), generator=gen, device="cuda")
    qlen = torch.randint(4, QLEN + 1, (BATCH,), generator=gen, device="cuda", dtype=torch.int32)
    q = torch.randint(1, FLAGSHIP["question_vocab_size"], (BATCH, QLEN), generator=gen, device="cuda",
                      dtype=torch.int32)
    q = q * (torch.arange(QLEN, device="cuda")[None, :] < qlen[:, None]).int()
    for dtype in ("float32", "bfloat16"):
        model.compute_dtype = dtype
        times[f"eval {dtype}"] = time_ms(lambda: model(app, mot, q, qlen), 5)
    print("RESULT " + json.dumps(times), flush=True)


@torch.no_grad()
def cuts():
    from dualvgr_tpu_torch.ops import gat_kernel
    from dualvgr_tpu_torch.ops.gat_kernel import card_plan, gat_cycle, gat_cycle_reference

    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(Path(tmp))
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for shape, h, scores, args in cases(torch.Generator(device="cuda").manual_seed(0)):
            plan = card_plan(*h.shape, HEADS)
            print(f"[{shape}] plan cluster={plan.cluster} clusters={plan.clusters} "
                  f"videos_per_cluster={plan.videos_per_cluster} ctas={plan.ctas} waves={plan.waves:.2f} "
                  f"tile_rows={plan.tile_rows} k_split={plan.k_split} col_passes={plan.col_passes} "
                  f"smem_bytes={plan.smem_bytes}", flush=True)
            want = gat_cycle_reference(h, scores, *args)
            times = {}
            for name in order:
                with _build.using(SOURCE, libs[name]):
                    if name != "committed" and gat_kernel.library_smem_bytes(*h.shape, HEADS, plan) < 0:
                        print(f"[{shape}] {name}: refuses the plan (its shared memory is over the limit)", flush=True)
                        continue
                    got = gat_cycle(h, scores, *args)
                    torch.cuda.synchronize()
                    if not name.startswith("no_"):
                        err = max((a - b).abs().max().item() for a, b in zip(got, want))
                        tol = 1e-3 * max(1.0, max(b.abs().max().item() for b in want))
                        if err > tol:
                            raise RuntimeError(f"{name} at {shape}: max abs err {err:.3e} > {tol:.3e}")
                    del got
                    times.setdefault(name, []).append(time_ms(lambda: gat_cycle(h, scores, *args), 20))
            base = sum(times["committed"]) / 2
            for name, ms in times.items():
                note = ""
                if name.startswith("no_"):
                    left = sum(ms) / 2
                    note = (f" (timing only: leaves {left:.4f} ms of the committed {base:.4f}; the cut "
                            f"part {base - left:.4f} ms, {100 * (base - left) / base:.1f}%)")
                print(f"[{shape}] {name}: " + " / ".join(f"{m:.4f}" for m in ms) + f" ms{note}", flush=True)
            del want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="a checkout of an earlier commit to time against")
    ap.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gat_kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.measure:
        measure()
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.baseline:
        against_baseline("dualvgr_tpu_torch.bench.gat_kernel_ab", args.baseline.resolve())
    else:
        cuts()


if __name__ == "__main__":
    main()
