"""Feature-extraction backbone throughput on the card.

The port's counterpart of the JAX package's ``benchmarks/
extraction_bench.py``. The reference extracts features one video at a time
(reference preprocess_features.py:143-203, batch 1); the features CLI
batches the frames and clips of several videos into one device call. This
measures that call's device time with CUDA events (seeded random weights:
the time does not depend on them):

* frames/s of ResNet-101 at 224^2, clips/s of ResNeXt-101 3D on 16-frame
  clips at 112^2, and videos/s at 16 clips x 16 frames (appearance alone,
  motion alone, and both: a video needs both);
* the analytic conv GFLOP per frame and per clip (``utils/flops.py``, the
  grouped convs counted as grouped), the TFLOP/s they give, and the least
  time the card could take at its fp32 peak (67 TFLOP/s, no TF32: the fp32
  extractors turn TF32 off) or bf16 peak (989 TFLOP/s);
* with ``--grouped-ab``, each grouped 3x3x3 conv shape of the motion
  network timed as cuDNN's grouped conv and as a dense conv with the
  block-diagonal weight (weight built per call, as the model builds it);
* with ``--layout-ab``, each extractor channels-last and in the default
  layout, in turns.

    python -m dualvgr_tpu_torch.bench.extraction_bench [--frames 1024] [--clips 64] [--grouped-ab]
        [--layout-ab]

It needs a CUDA device; its last line is one JSON object with the card's
name.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from dualvgr_tpu_torch.bench.timing import time_ms
from dualvgr_tpu_torch.models.backbones.resnext3d import blockdiag_weight
from dualvgr_tpu_torch.preprocess.features import build_appearance_extractor, build_motion_extractor
from dualvgr_tpu_torch.utils.flops import resnet101_flops, resnext101_3d_flops

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
FRAMES_PER_VIDEO, CLIPS_PER_VIDEO = 256, 16  # 16 clips x 16 frames


def rates(app_ms: float, mot_ms: float, n_frames: int, n_clips: int, compute_dtype: str) -> dict:
    """The throughput numbers of one appearance call on ``n_frames`` frames
    and one motion call on ``n_clips`` clips."""
    fa, fm = resnet101_flops(), resnext101_3d_flops()
    peak = PEAK_FLOPS[compute_dtype]
    fps, cps = n_frames / app_ms * 1e3, n_clips / mot_ms * 1e3
    v_app, v_mot = fps / FRAMES_PER_VIDEO, cps / CLIPS_PER_VIDEO
    return {
        "app_ms": app_ms, "frames_per_s": fps, "videos_per_s_appearance": v_app,
        "app_gflop_per_frame": fa / 1e9, "app_tflop_per_s": fa * fps / 1e12,
        "app_bound_ms": fa * n_frames / peak * 1e3,
        "mot_ms": mot_ms, "clips_per_s": cps, "videos_per_s_motion": v_mot,
        "mot_gflop_per_clip": fm / 1e9, "mot_tflop_per_s": fm * cps / 1e12,
        "mot_bound_ms": fm * n_clips / peak * 1e3,
        "videos_per_s": 1.0 / (1.0 / v_app + 1.0 / v_mot),
    }


def seeded_inputs(n_frames: int, n_clips: int, seed: int = 5):
    """Raw 0-255 pixels on the card: (n_frames, 3, 224, 224) frames and
    (n_clips, 3, 16, 112, 112) clips, integer-valued as decoded video is."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (n_frames, 3, 224, 224), generator=gen, device="cuda").float()
    clips = torch.randint(0, 256, (n_clips, 3, 16, 112, 112), generator=gen, device="cuda").float()
    return frames, clips


def measure(compute_dtype: str, frames: torch.Tensor, clips: torch.Tensor, iters: int = 3,
            channels_last: bool | None = None, app_extract=None, mot_extract=None) -> dict:
    """Time both extractors (built here unless given) at ``compute_dtype``
    on ``frames`` and ``clips`` on the card."""
    app = app_extract or build_appearance_extractor(device="cuda", compute_dtype=compute_dtype,
                                                    channels_last=channels_last)
    mot = mot_extract or build_motion_extractor(device="cuda", compute_dtype=compute_dtype,
                                                channels_last=channels_last)
    return rates(time_ms(lambda: app(frames), iters), time_ms(lambda: mot(clips), iters), len(frames), len(clips),
                 compute_dtype)


def layout_ab(compute_dtype: str, frames: torch.Tensor, clips: torch.Tensor, iters: int = 2) -> dict:
    """Each extractor's ms channels-last and in the default layout, in turns
    (channels-last, default, default, channels-last)."""
    out = {}
    for kind, build, x in (("app", build_appearance_extractor, frames), ("mot", build_motion_extractor, clips)):
        ext = {cl: build(device="cuda", compute_dtype=compute_dtype, channels_last=cl) for cl in (True, False)}
        times = {True: [], False: []}
        for cl in (True, False, False, True):
            times[cl].append(time_ms(lambda: ext[cl](x), iters))
        out[f"{kind}_channels_last_ms"], out[f"{kind}_default_ms"] = times[True], times[False]
    return out


def grouped_shapes(n_clips: int):
    """(channels, stride, input (N, C, T, H, W)) of each distinct grouped
    conv of ``ResNeXt101_3D`` on ``n_clips`` 16 x 112 x 112 clips."""
    out, t, h = [], 8, 28  # after the stem and the max pool
    for stage, planes in enumerate((128, 256, 512, 1024)):
        for s in ((1,) if stage == 0 else (2, 1)):
            out.append((planes, s, (n_clips, planes, t, h, h)))
            if s == 2:
                t, h = (t - 1) // 2 + 1, (h - 1) // 2 + 1
    return out


def grouped_ab(compute_dtype: str, n_clips: int, iters: int = 5, groups: int = 32) -> list[dict]:
    """Each grouped conv shape timed grouped and block-diagonal, in turns
    (grouped, blockdiag, blockdiag, grouped), channels-last as the model
    runs them; the two results' largest difference against the grouped's
    largest value."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[compute_dtype]
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for c, s, shape in grouped_shapes(n_clips):
            x = torch.randn(shape, generator=gen, device="cuda").to(dt).contiguous(
                memory_format=torch.channels_last_3d)
            w = (torch.randn((c, c // groups, 3, 3, 3), generator=gen, device="cuda") * 0.05).to(
                memory_format=torch.channels_last_3d)

            def grouped():
                return F.conv3d(x, w.to(dt), None, s, 1, 1, groups)

            def blockdiag():
                return F.conv3d(x, blockdiag_weight(w.to(dt), groups), None, s, 1)

            a, b = grouped(), blockdiag()
            err = ((a.float() - b.float()).abs().max() / a.float().abs().max()).item()
            g1, b1 = time_ms(grouped, iters), time_ms(blockdiag, iters)
            b2, g2 = time_ms(blockdiag, iters), time_ms(grouped, iters)
            rows.append({"channels": c, "stride": s, "input": list(shape), "grouped_ms": [g1, g2],
                         "blockdiag_ms": [b1, b2], "rel_err": err,
                         "faster": "blockdiag" if b1 + b2 < g1 + g2 else "grouped"})
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024, help="appearance batch (frames)")
    ap.add_argument("--clips", type=int, default=64, help="motion batch (16-frame clips)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--grouped-ab", action="store_true")
    ap.add_argument("--layout-ab", action="store_true", help="channels-last against the default layout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("extraction_bench needs a CUDA device")
    out = {"device": torch.cuda.get_device_name(0)}
    frames, clips = seeded_inputs(args.frames, args.clips)
    for dt in ("float32", "bfloat16"):
        out[dt] = measure(dt, frames, clips, args.iters)
        if args.grouped_ab:
            out[f"grouped_ab_{dt}"] = grouped_ab(dt, args.clips)
        if args.layout_ab:
            out[f"layout_ab_{dt}"] = layout_ab(dt, frames, clips)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
