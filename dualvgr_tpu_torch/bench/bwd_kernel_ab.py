"""A/B timing of build variants of kernel 4 (``csrc/bilstm_train_bwd.cu``).

    python -m dualvgr_tpu_torch.bench.bwd_kernel_ab

Needs one CUDA device and ``nvcc``. Each variant is the committed source
with its two launch lines given other template arguments (``launch<kTy,
kRowsPerThread, kSplit, kRows2, kUnits2, kUnroll2>``: the 16-row tile of
the appearance encoder, the 4-row tile of the question encoders), or with
a product's loop cut to zero steps for timing only. ``kSplit = 1`` is the
dh product in the gate product's thread layout, the kernel's first
version. Every variant is compiled as ``ops/_build.py`` compiles the
source, run through the port's wrapper at the three shapes of the flagship
train step (the appearance encoder, ``concatRNN``, the question
``encoder``) on the model's projections with seeded cotangents, checked
against the plain version where its results are meant to be right, and
timed with CUDA events, the variants interleaved (forward order, then
reversed) in one process on one card. fp32, TF32 off.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from dualvgr_tpu_torch.models.dualvgr import build_model
from dualvgr_tpu_torch.ops import _build
from dualvgr_tpu_torch.ops.lstm import time_major_input_proj
from dualvgr_tpu_torch.ops.lstm_train_kernel import (
    bilstm_train_bwd, bilstm_train_bwd_reference, bilstm_train_fwd_reference,
)

SOURCE = "bilstm_train_bwd.cu"
LAUNCH_16, LAUNCH_4 = "launch<2, 8, 4, 8, 12, 1>", "launch<4, 1, 4, 4, 3, 4>"
GATE_LOOP = "for (int k = 0; k < H; k += 4) {"
DH_LOOP = "for (int k = 0; k < k_len; k += 4) {"
FLAT_16, FLAT_4 = "launch<2, 8, 1, 8, 3, {u}>", "launch<4, 1, 1, 1, 3, {u}>"
# name -> (16-row launch, 4-row launch, loops cut to zero steps)
VARIANTS = {
    "committed": (LAUNCH_16, LAUNCH_4, ()),
    "flat": (FLAT_16.format(u=1), FLAT_4.format(u=1), ()),
    "flat_4x6": ("launch<2, 8, 1, 4, 6, 1>", FLAT_4.format(u=1), ()),
    "flat_unroll2": (FLAT_16.format(u=2), FLAT_4.format(u=2), ()),
    "flat_unroll4": (FLAT_16.format(u=4), FLAT_4.format(u=4), ()),
    "flat_unroll8": (FLAT_16.format(u=8), FLAT_4.format(u=8), ()),
    "flat_no_gate_product": (FLAT_16.format(u=1), FLAT_4.format(u=1), (GATE_LOOP,)),
    "flat_no_dh_product": (FLAT_16.format(u=1), FLAT_4.format(u=1), (DH_LOOP,)),
    "flat_no_products": (FLAT_16.format(u=1), FLAT_4.format(u=1), (GATE_LOOP, DH_LOOP)),
}
FLAGSHIP = dict(vision_dim=2048, module_dim=768, word_dim=300, question_vocab_size=8000,
                num_answers=4000, num_of_nodes=16, graph_layers=1, unit_layers=1)
BATCH, CLIPS, FRAMES, QLEN = 256, 16, 16, 24


def variant_source(text: str, launch16: str, launch4: str, cut) -> str:
    for old, new in ((LAUNCH_16, launch16), (LAUNCH_4, launch4)):
        if old not in text:
            raise RuntimeError(f"{SOURCE} has no `{old}`: update the variants")
        text = text.replace(old, new)
    for loop in cut:
        if loop not in text:
            raise RuntimeError(f"{SOURCE} has no `{loop}`: update the variants")
        text = text.replace(loop, loop.replace("k < ", "k < 0 * "))
    return text


def build_variants(workdir: Path) -> dict[str, ctypes.CDLL]:
    """Compile every variant, all ``nvcc``s at once."""
    text = (_build.CSRC / SOURCE).read_text()
    procs = {}
    for name, (l16, l4, cut) in VARIANTS.items():
        src = workdir / f"{name}.cu"
        src.write_text(variant_source(text, l16, l4, cut))
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


def time_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@torch.no_grad()
def cases(gen):
    """(name, backward args) at the three shapes of the flagship train step."""
    model = build_model(seed=0, **FLAGSHIP)
    dev = gen.device
    app = torch.randn((BATCH, CLIPS, FRAMES, FLAGSHIP["vision_dim"]), generator=gen, device=dev)
    qlen = torch.randint(4, QLEN + 1, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    q = torch.randint(1, FLAGSHIP["question_vocab_size"], (BATCH, QLEN), generator=gen, device=dev)
    q = q * (torch.arange(QLEN, device=dev)[None, :] < qlen[:, None])
    words = torch.tanh(model.linguistic_input_unit.encoder_embed(q))
    clips = torch.tanh(app).reshape(BATCH * CLIPS, FRAMES, -1)
    qe = model.linguistic_input_unit
    for name, enc, x, lens, outs in (
        ("appearance", model.visual_appearance_input_unit.encoder, clips, None, False),
        ("question_outputs", qe.concatRNN.rnn, words, qlen, True),
        ("question_final", qe.encoder, words, qlen, False),
    ):
        fwd, bwd = enc._params(""), enc._params("_reverse")
        xf, xb = time_major_input_proj(x, fwd), time_major_input_proj(x, bwd, reverse=True)
        whf, whb = fwd.w_hh.t().contiguous(), bwd.w_hh.t().contiguous()
        _, _, hprev, cprev = bilstm_train_fwd_reference(xf, xb, whf, whb, lens, with_outputs=outs)
        t, r, g = xf.shape
        dfinal = torch.randn((r, g // 2), generator=gen, device=dev)
        douts = torch.randn((r, t, g // 2), generator=gen, device=dev) if outs else None
        yield name, (xf, xb, whf, whb, lens, hprev, cprev, dfinal, douts)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bwd_kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build_variants(Path(tmp))
        order = list(VARIANTS) + list(VARIANTS)[::-1]
        for shape, args in cases(torch.Generator(device="cuda").manual_seed(0)):
            want = bilstm_train_bwd_reference(*args)
            times = {}
            for name in order:
                # the wrapper loads its library through _build; hand it the variant's
                _build._libs[SOURCE] = libs[name]
                got = bilstm_train_bwd(*args)
                torch.cuda.synchronize()
                err = max((a - b).abs().max().item() for a, b in zip(got, want))
                if not VARIANTS[name][2] and err > 1e-3 * max(1.0, max(b.abs().max().item() for b in want)):
                    raise RuntimeError(f"{name} at {shape}: max abs err {err:.3e} against the plain version")
                times.setdefault(name, []).append(time_ms(lambda: bilstm_train_bwd(*args)))
            for name, ms in times.items():
                note = " (timing only: a product cut)" if VARIANTS[name][2] else ""
                print(f"[{shape}] {name}: " + " / ".join(f"{m:.4f}" for m in ms) + f" ms{note}", flush=True)
        _build._libs.pop(SOURCE, None)


if __name__ == "__main__":
    main()
