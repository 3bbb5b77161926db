"""Probe: the appearance encoder's bf16 input projection, five ways, on the card.

    python -m dualvgr_tpu_torch.bench.proj_probe [--rows 4096] [--iters 20]

The port's counterpart of ``benchmarks/proj_probe.py``. Needs one CUDA
device and ``nvcc``. Every variant computes the same pair, ``xf`` (T, R, 4H)
and the time-reversed ``xb`` (T, R, 4H) in bf16, from x (R, T, D) fp32 at
the flagship widths (T = 16, D = 2048, 4H = 1536):

  v0_library  tanh pass -> bf16 -> two bf16 products with an fp32 output
              (``torch.mm(..., out_dtype=torch.float32)``) -> the bias ->
              bf16 -> time-major copy, the backward one flipped
  v1_merged   the same with one product against [W_f | W_b]
  v2_kernel5  two launches of kernel 5 (``input_proj_one``), tanh fused, the
              backward one written time-reversed
  v3_kernel6  one launch of kernel 6 (``input_proj_both``), tanh fused
  v4_tanh_kernel6  a tanh pass to bf16, then kernel 6 without tanh

Before timing, each variant is held against the plain version of the
function (``input_proj_both_reference``) on the same inputs: the outputs
are bf16, and a sum taken in another order may land on the other side of
a bf16 rounding boundary, so the gate allows one bf16 step of the
reference's magnitude plus 1e-5 for outputs near zero, where the fp32 sum
cancels; it reports the largest difference in such steps (after the 1e-5)
and the share of elements that differ. Times are CUDA events over
``--iters`` calls after a warm-up; the last line is one JSON object. TF32
is off.
"""

from __future__ import annotations

import argparse
import json

import torch

from dualvgr_tpu_torch.ops.precision import mm_f32
from dualvgr_tpu_torch.ops.proj_kernel import input_proj_both, input_proj_both_reference, input_proj_one

T, D, G = 16, 2048, 1536
BF16 = torch.bfloat16


def make_inputs(rows: int, gen: torch.Generator):
    """x (rows, T, D) and two directions' (w_ih (G, D), bias (G,)), the
    probe's scales (weights 0.02), from ``gen`` on its device."""
    dev = gen.device
    x = torch.randn((rows, T, D), generator=gen, device=dev)
    w_f, w_b = (torch.randn((G, D), generator=gen, device=dev) * 0.02 for _ in range(2))
    b_f, b_b = (torch.randn((G,), generator=gen, device=dev) for _ in range(2))
    return x, w_f, b_f, w_b, b_b


def variants(x, w_f, b_f, w_b, b_b):
    """name -> callable returning (xf, xb_rev)."""
    r = x.shape[0]
    w16_f, w16_b = w_f.to(BF16), w_b.to(BF16)
    w16_cat, b_cat = torch.cat([w16_f, w16_b]), torch.cat([b_f, b_b])

    def time_major(y):  # (R*T, G) fp32 -> (T, R, G) bf16
        return y.to(BF16).view(r, T, -1).transpose(0, 1).contiguous()

    def v0():
        a = torch.tanh(x).to(BF16).view(r * T, D)
        xf = time_major(mm_f32(a, w16_f.t()) + b_f)
        xb = time_major(mm_f32(a, w16_b.t()) + b_b).flip(0)
        return xf, xb

    def v1():
        a = torch.tanh(x).to(BF16).view(r * T, D)
        p = time_major(mm_f32(a, w16_cat.t()) + b_cat)
        return p[..., :G].contiguous(), p[..., G:].flip(0)

    def v2():
        return input_proj_one(x, w_f, b_f), input_proj_one(x, w_b, b_b, reverse=True)

    def v3():
        return input_proj_both(x, w_f, b_f, w_b, b_b)

    def v4():
        return input_proj_both(torch.tanh(x).to(BF16), w_f, b_f, w_b, b_b, fuse_tanh=False)

    return {"v0_library": v0, "v1_merged": v1, "v2_kernel5": v2, "v3_kernel6": v3, "v4_tanh_kernel6": v4}


def bf16_step(ref):
    """One bf16 rounding step at each element's magnitude (2^-7 of its binade)."""
    mag = ref.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def compare(got, want, atol=1e-5):
    """(largest difference in bf16 steps of the reference, after ``atol``;
    share of elements that differ; whether that largest difference is at
    most one step)."""
    diff = (got.float() - want.float()).abs()
    steps = ((diff - atol).clamp(min=0) / bf16_step(want)).max().item()
    return steps, (diff > 0).float().mean().item(), steps <= 1.0


def time_ms(fn, iters):
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
def run(rows: int = 4096, iters: int = 20, seed: int = 0) -> dict:
    """Gate every variant against the plain version, then time each; raises
    if one disagrees."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = make_inputs(rows, gen)
    want = input_proj_both_reference(*args)
    out = {"rows": rows, "T": T, "D": D, "4H": G}
    fns = variants(*args)
    for name, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        steps, share, ok = zip(*(compare(g, w) for g, w in zip(got, want)))
        if not all(ok):
            raise RuntimeError(f"proj_probe {name}: differs from the plain version by {max(steps):.1f} bf16 steps")
        out[f"{name}_max_steps"] = max(steps)
        out[f"{name}_share_differ"] = max(share)
    del want
    for name, fn in fns.items():
        out[f"{name}_ms"] = time_ms(fn, iters)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=4096)  # B*C at the flagship batch of 256
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("proj_probe: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    print(json.dumps(run(args.rows, args.iters)), flush=True)


if __name__ == "__main__":
    main()
