"""A/B timing of kernel 4 (``csrc/bilstm_train_bwd.cu``), the BiLSTM backward.

    python -m dualvgr_tpu_torch.bench.bwd_kernel_ab
    python -m dualvgr_tpu_torch.bench.bwd_kernel_ab --baseline DIR

Needs one CUDA device and ``nvcc``. Without ``--baseline`` it builds the
committed source, a build variant (the dh product's loop not unrolled; the
source unrolls it by 2) and timing-only cuts of it, all ``nvcc``s at once,
through ``ops/_build.py::build_variants``: the dh product cut, the
reduce-scatter cut (each CTA stores its partials into its own receive
buffer, so the product stays live, and nothing is waited for) and the
cell's transcendental cut (the tanh of c_t gone, the rest of the cell
kept). It runs each through the port's wrapper at the three shapes of the
flagship train step (the appearance encoder: T 16, R 4096, unmasked, final
only; ``concatRNN``: T 24, R 256, lengths 4..24, with ``douts``; the
question ``encoder``: the same, final only) and the appearance shape on the
same gates rounded to bf16, H 384, seeded random gates and weights, the
activations and c_{t-1} from the plain forward. The committed build and the
variant are checked against the plain version (1e-3 x max(1, max|ref|));
every build is timed with CUDA events, interleaved (forward order, then
reversed) in one process on one card, and each cut is printed beside what
it leaves of the committed time.

With ``--baseline DIR`` (a checkout of an earlier commit of the repo) it
runs the measurement of DIR's copy of this script in DIR's package and this
one's here, in turns (baseline, this, this, baseline), one process each on
the same card (``bench/timing.py::against_baseline``): kernel 4 on the
tree's own kernel 3 outputs (the activations and c_{t-1}; a tree whose
kernel 4 recomputes the gates takes the gates and both residuals instead,
and cannot be the baseline), and kernels 1 and 3 beside it, at the same
shapes and gates (fp32, and bf16 gates at the appearance shape), and the
flagship eval forward at batch 256 in fp32 and bf16. It prints each time
per run and this tree's mean against the baseline's. fp32, TF32 off.
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

SOURCE = "bilstm_train_bwd.cu"
DH_LOOP = "for (int c = 0; c < 4 * units; c += 4) {"
DST = "dst[j] = in_rank(smem_u32(my_slot + k % units), k / units);"
WAITS = ("mbar_wait(smem_u32(&bars[0]), fullpar);", "mbar_wait(smem_u32(&bars[1]), freepar);",
         "arrive_remote(in_rank(smem_u32(&bars[0]), i));", "arrive_remote(in_rank(smem_u32(&bars[1]), i));")
CELL = "const float tc = tanhf(fg * c_prev[s] + ig * gg);"
DH_UNROLL = "#pragma unroll 2\n      for (int c = 0;"
# name -> the replacements that make it; the cuts ("no_*") are timing only
VARIANTS = {
    "committed": (),
    "dh_unroll1": ((DH_UNROLL, DH_UNROLL.replace("unroll 2", "unroll 1")),),
    "no_dh_product": ((DH_LOOP, DH_LOOP.replace("c < 4 * units", "c < 0 * units")),),
    # every partial stored into this CTA's own receive buffer (so the dh
    # product stays live), no arrival, no wait: the reduce sums stale values
    "no_reduce_scatter": ((DST, DST.replace("k / units)", "rank)")), *((line, ";") for line in WAITS)),
    "no_transcendentals": ((CELL, "const float tc = fg * c_prev[s] + ig * gg;"),),
}
H, G = 384, 4 * 384
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
    """Compile every variant, all ``nvcc``s at once, against the committed
    headers of ``csrc/``."""
    text = (_build.CSRC / SOURCE).read_text()
    built = _build.build_variants(SOURCE, {name: {SOURCE: variant_source(text, cuts)}
                                           for name, cuts in VARIANTS.items()}, workdir)
    for name, (_, out) in built.items():
        regs = [line.split(":")[-1].strip() for line in out.splitlines() if "Used" in line or "spill" in line]
        print(f"[build] {name}: {'; '.join(regs)}", flush=True)
    return {name: lib for name, (lib, _) in built.items()}


def backward_args(fwd, fargs, dfinal, douts):
    """Kernel 4's arguments from the outputs ``fwd`` of kernel 3 (or of its
    plain version) on ``fargs``: the activations and c_{t-1}."""
    _, _, _, cprev, acts = fwd
    return (acts, *fargs[2:], cprev, dfinal, douts)


@torch.no_grad()
def cases(gen, forward):
    """(name, forward args, with_outputs, backward args) at the three
    shapes of the flagship train step, then the appearance shape with bf16
    gates, kernel 4's arguments from ``forward`` (kernel 3 or its plain
    version)."""
    dev = gen.device
    w = [torch.randn((H, G), generator=gen, device=dev) * 0.05 for _ in range(2)]
    lens = torch.randint(4, QLEN + 1, (256,), generator=gen, device=dev, dtype=torch.int32)
    for name, t, r, lengths, outs in (("appearance", 16, 4096, None, False),
                                      ("question_outputs", QLEN, 256, lens, True),
                                      ("question_final", QLEN, 256, lens, False)):
        xf, xb = (torch.randn((t, r, G), generator=gen, device=dev) for _ in range(2))
        gate_sets = [(name, xf, xb)]
        if name == "appearance":
            gate_sets.append(("appearance_bf16", xf.to(torch.bfloat16), xb.to(torch.bfloat16)))
        for case, gf, gb in gate_sets:
            fargs = (gf, gb, *w, lengths)
            dfinal = torch.randn((r, 2 * H), generator=gen, device=dev)
            douts = torch.randn((r, t, 2 * H), generator=gen, device=dev) if outs else None
            yield case, fargs, outs, backward_args(forward(*fargs, with_outputs=outs), fargs, dfinal, douts)


@torch.no_grad()
def measure():
    """This process's package: kernels 1, 3 and 4 per shape and the eval
    forwards, printed as one ``RESULT`` JSON line."""
    from dualvgr_tpu_torch import build_model
    from dualvgr_tpu_torch.ops.lstm_kernel import bilstm_recurrence
    from dualvgr_tpu_torch.ops.lstm_train_kernel import bilstm_train_bwd, bilstm_train_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    times = {}
    for name, fargs, outs, bargs in cases(torch.Generator(device="cuda").manual_seed(0), bilstm_train_fwd):
        times[f"kernel 1 {name}"] = time_ms(lambda: bilstm_recurrence(*fargs, with_outputs=outs), 10)
        times[f"kernel 3 {name}"] = time_ms(lambda: bilstm_train_fwd(*fargs, with_outputs=outs), 10)
        times[f"kernel 4 {name}"] = time_ms(lambda: bilstm_train_bwd(*bargs), 10)
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
    from dualvgr_tpu_torch.ops.lstm_train_kernel import (
        bilstm_train_bwd, bilstm_train_bwd_reference, bilstm_train_fwd_reference,
    )

    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(Path(tmp))
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for shape, _, _, args in cases(torch.Generator(device="cuda").manual_seed(0), bilstm_train_fwd_reference):
            want = bilstm_train_bwd_reference(*args)
            times = {}
            for name in order:
                with _build.using(SOURCE, libs[name]):
                    got = bilstm_train_bwd(*args)
                    torch.cuda.synchronize()
                    if not name.startswith("no_"):
                        err = max((a - b).abs().max().item() for a, b in zip(got, want))
                        tol = 1e-3 * max(1.0, max(b.abs().max().item() for b in want))
                        if err > tol:
                            raise RuntimeError(f"{name} at {shape}: max abs err {err:.3e} > {tol:.3e}")
                    del got
                    times.setdefault(name, []).append(time_ms(lambda: bilstm_train_bwd(*args), 10))
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
        raise SystemExit("bwd_kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.measure:
        measure()
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.baseline:
        against_baseline("dualvgr_tpu_torch.bench.bwd_kernel_ab", args.baseline.resolve())
    else:
        cuts()


if __name__ == "__main__":
    main()
