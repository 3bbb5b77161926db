"""Feature-extraction CLI: videos -> clip features -> HDF5, on the card.

The port's counterpart of the JAX package's
``preprocess/preprocess_features.py`` (reference
preprocess/preprocess_features.py:206-277), with its flags plus
``--device cuda|cpu`` (default cuda; there is no fallback):

    python -m dualvgr_tpu_torch.preprocess.features --dataset svqa \\
        --model resnet101 --annotation_file .../train_qa.json \\
        --video_dir .../videos/ [--ckpt resnet101.pth] --num_clips 8 \\
        [--compute-dtype bfloat16] [--device cpu]

The pipeline, split in three so that the card can start from decoded
frames (its host has no cv2):

* ``decode_video_rgb(path)``: the whole video as (T, H, W, 3) uint8 RGB
  frames (cv2; ``ImportError`` naming cv2 where it is missing);
* ``sample_clip_indices(total_frames, num_clips, F)``: the reference
  sampler's frame indices, ``num_clips`` centers at
  linspace(0, T, num_clips + 2)[1:num_clips + 1], 16 consecutive frames
  around each with the boundary frames replicated (reference :67-140);
* ``clips_from_frames(frames, ...)``: the frames cross to the device as
  uint8 and are resized there with PIL's bicubic filter written in torch
  (``resize.py``) to 224^2 (appearance) or 112^2 (motion).

``extract_clips_with_consecutive_frames`` composes the three, as the JAX
function of that name does. Only a file that yields no frames is a broken
video (zero features and ``valid`` False, as the reference writes them);
any other failure raises.

The extractors take the JAX package's torch-layout inputs on the device:
ResNet-101 (B, 3, H, W) raw 0-255, normalised inside with the reference's
mean and std (its 0.224 typo kept); ResNeXt-101 3D (B, 3, F, H, W) raw,
not normalised (reference :182-186). An fp32 extractor runs its convs with
cuDNN's TF32 off (PyTorch's default is on), restoring the flag after each
call; channels-last where the card measured it faster (``CHANNELS_LAST``);
bf16 runs the convs and BatchNorm in bf16 with fp32 parameters and
returns fp32 features. ``generate_h5`` batches ``--videos_per_batch``
videos of frames into one device call and writes the reference's HDF5
schema (``resnet_features`` (N, clips, 16, 2048) or ``resnext_features``
(N, clips, 2048), float32, and ``ids``), the video list shuffled with the
seeded RNG as the reference does (:244). ``h5py`` and ``cv2`` are imported
only where a file is written or decoded.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import queue
import random
import sys
import threading
import time

import numpy as np
import torch

from dualvgr_tpu_torch.models.backbones.resnet2d import (
    IMAGENET_MEAN, IMAGENET_STD_REF, ResNet101, port_resnet101_state_dict,
)
from dualvgr_tpu_torch.models.backbones.resnext3d import ResNeXt101_3D, port_resnext101_state_dict
from dualvgr_tpu_torch.preprocess.datautils import msrvtt_qa, msvd_qa, svqa
from dualvgr_tpu_torch.preprocess.resize import resize_bicubic
from dualvgr_tpu_torch.utils.device import resolve_device
from dualvgr_tpu_torch.utils.trace import count, span

FRAMES_PER_CLIP = 16


def decode_video_rgb(path: str) -> np.ndarray:
    """Every frame of ``path`` as (T, H, W, 3) uint8 RGB (T = 0 when cv2
    cannot open or read it; reference :80-91)."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("decoding a video needs cv2 (opencv-python), which is not installed; "
                          "start from decoded frames with clips_from_frames instead") from e
    cap = cv2.VideoCapture(path)
    frames = []
    if cap.isOpened():
        rval, frame = cap.read()
        while rval:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            rval, frame = cap.read()
    cap.release()
    if not frames:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return np.stack(frames)


def sample_clip_indices(total_frames: int, num_clips: int, num_frames_per_clip: int) -> np.ndarray:
    """(num_clips, F) frame indices of the reference sampler, its boundary
    replication and short-video padding as it has them (reference
    :88-106)."""
    f = num_frames_per_clip
    out = []
    for i in np.linspace(0, total_frames, num_clips + 2, dtype=np.int32)[1: num_clips + 1]:
        clip_start = int(i) - f // 2
        clip_end = int(i) + f // 2
        if clip_start < 0:
            clip_start = 0
        if clip_end > total_frames:
            clip_end = total_frames - 1
        clip = list(range(total_frames))[clip_start:clip_end]
        shortage = f - (clip_end - clip_start)
        if clip_start == 0 and shortage > 0:
            clip = [clip_start] * shortage + clip
        if clip_end == (total_frames - 1) and f - len(clip) > 0:
            clip = clip + [clip_end] * (f - len(clip))
        while len(clip) < f:  # degenerate very short videos
            clip.append(clip[-1])
        out.append(clip[:f])
    return np.asarray(out, np.int64)


def clips_from_frames(frames, num_clips: int, num_frames_per_clip: int, image_size, motion_layout: bool,
                      device="cuda") -> torch.Tensor:
    """Sampled, resized clips of decoded ``frames`` ((T, H, W, 3) uint8,
    numpy or a tensor on any device) as float32 0-255 on ``device``:
    (clips, F, 3, H', W') or, with ``motion_layout``, (clips, 3, F, H', W').
    ``image_size`` is PIL's (width, height), as the JAX sampler passes it to
    ``resize``. The sampled frames cross to the device as uint8; each
    distinct one is resized once there."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames)
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (T, H, W, 3) uint8, got {tuple(frames.shape)} {frames.dtype}")
    idx = sample_clip_indices(frames.shape[0], num_clips, num_frames_per_clip)
    used, inverse = np.unique(idx, return_inverse=True)
    picked = frames[torch.from_numpy(used).to(frames.device)].to(dev, non_blocking=True).permute(0, 3, 1, 2)
    width, height = image_size
    resized = resize_bicubic(picked, (height, width))  # (U, 3, h, w) uint8
    clips = resized[torch.from_numpy(inverse.reshape(idx.shape)).to(dev)].float()  # (clips, F, 3, h, w)
    return clips.transpose(1, 2) if motion_layout else clips


def extract_clips_with_consecutive_frames(path, num_clips, num_frames_per_clip, image_size, motion_layout,
                                          device="cuda"):
    """(clips ndarray float32, valid) of the video at ``path``: appearance
    layout (clips, F, 3, H, W), motion layout (clips, 3, F, H, W). A video
    that yields no frames gives zeros and False (reference :174, :188)."""
    frames = decode_video_rgb(path)
    if len(frames) == 0:
        print(f"file {path} error")
        width, height = image_size
        shape = (num_clips, 3, num_frames_per_clip) if motion_layout else (num_clips, num_frames_per_clip, 3)
        return np.zeros((*shape, height, width), np.float32), False
    clips = clips_from_frames(frames, num_clips, num_frames_per_clip, image_size, motion_layout, device)
    return clips.cpu().numpy(), True


@contextlib.contextmanager
def _cudnn_fp32(on: bool):
    """cuDNN without TF32 while an fp32 extractor runs (PyTorch's default
    lets cuDNN run fp32 convs as TF32); the flag as it was afterwards."""
    if not on:
        yield
        return
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# the memory layout each backbone runs in on the card, by compute dtype:
# channels-last where the H100 measured it faster (PERF.md §5,
# ``bench/extraction_bench.py --layout-ab``); the features do not change
CHANNELS_LAST = {("appearance", "float32"): False, ("appearance", "bfloat16"): True,
                 ("motion", "float32"): True, ("motion", "bfloat16"): True}


def _load_ckpt(path: str) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd and "conv1.weight" not in sd:
        sd = sd["state_dict"]
    return sd


def _seeded(build, seed: int):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _layout(kind: str, compute_dtype: str, dev: torch.device, channels_last: bool | None):
    """The memory format of ``kind``'s weights and inputs, or None for the
    default: channels-last only on the card, as ``CHANNELS_LAST`` has it
    unless ``channels_last`` says."""
    if dev.type != "cuda":
        return None
    if channels_last is None:
        channels_last = CHANNELS_LAST[(kind, compute_dtype)]
    if not channels_last:
        return None
    return torch.channels_last if kind == "appearance" else torch.channels_last_3d


def build_backbone(kind: str, ckpt_path: str = "", device="cuda", compute_dtype: str = "float32",
                   layers=(3, 4, 23, 3), seed: int = 0, channels_last: bool | None = None):
    """The eval-mode ``ResNet101`` (``kind`` "appearance") or
    ``ResNeXt101_3D`` ("motion") on ``device``, its weights from a
    torchvision / Kinetics ``.pth`` state_dict at ``ckpt_path`` or, without
    one, seeded at random from ``seed``; channels-last on the card as
    ``CHANNELS_LAST`` has it unless ``channels_last`` says."""
    dev = resolve_device(device)
    if kind == "appearance":
        model = _seeded(lambda: ResNet101(layers, compute_dtype), seed)
        port = port_resnet101_state_dict
    elif kind == "motion":
        model = _seeded(lambda: ResNeXt101_3D(layers, compute_dtype=compute_dtype), seed)
        port = port_resnext101_state_dict
    else:
        raise ValueError(f"kind must be appearance or motion, got {kind!r}")
    if ckpt_path:
        model.load_state_dict(port(_load_ckpt(ckpt_path)), strict=True)
    else:
        print(f"WARNING: no checkpoint given; using random {type(model).__name__} weights (seed {seed})",
              file=sys.stderr)
    model = model.to(dev).eval()
    fmt = _layout(kind, compute_dtype, dev, channels_last)
    return model if fmt is None else model.to(memory_format=fmt)


# the tracer's span and counter of each backbone: one span a call, and
# the frames (appearance) or clips (motion) it took
_TRACED = {"appearance": ("extract.appearance", "extract.frames"), "motion": ("extract.motion", "extract.clips")}


def _extractor(kind, model, normalize, dev, channels_last):
    fp32_cuda = dev.type == "cuda" and model.compute_dtype == "float32"
    fmt = _layout(kind, model.compute_dtype, dev, channels_last)
    span_name, counter = _TRACED[kind]

    def extract(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32).to(dev, non_blocking=True)
        count(counter, x.shape[0])
        with span(span_name), torch.no_grad(), _cudnn_fp32(fp32_cuda):
            if normalize is not None:
                x = normalize(x)
            if fmt is not None:
                x = x.contiguous(memory_format=fmt)
            return model(x)

    extract.model = model
    return extract


def build_appearance_extractor(ckpt_path="", device="cuda", compute_dtype="float32", layers=(3, 4, 23, 3),
                               seed: int = 0, channels_last: bool | None = None):
    """frames (B, 3, H, W) raw 0-255 -> (B, 2048) fp32 features on the
    device: ``(x / 255 - mean) / std``, then ResNet-101."""
    dev = resolve_device(device)
    model = build_backbone("appearance", ckpt_path, dev, compute_dtype, layers, seed, channels_last)
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD_REF, device=dev).view(1, 3, 1, 1)
    return _extractor("appearance", model, lambda x: (x / 255.0 - mean) / std, dev, channels_last)


def build_motion_extractor(ckpt_path="", device="cuda", compute_dtype="float32", layers=(3, 4, 23, 3),
                           seed: int = 1, channels_last: bool | None = None):
    """clips (B, 3, F, H, W) raw 0-255 -> (B, 2048) fp32 features on the
    device (no normalization, reference :182-186)."""
    dev = resolve_device(device)
    model = build_backbone("motion", ckpt_path, dev, compute_dtype, layers, seed, channels_last)
    return _extractor("motion", model, None, dev, channels_last)


def generate_h5(args, video_paths, extractor=None):
    """Decode (threaded) -> batched inference on the device -> HDF5,
    written as the batches finish. ``extractor`` (optional) replaces the
    one ``args`` names (``ckpt``, ``device``, ``compute_dtype``)."""
    import h5py

    dev = resolve_device(getattr(args, "device", "cuda"))
    appearance = args.feature_type == "appearance"
    f = FRAMES_PER_CLIP
    image_size = (args.image_height, args.image_width)
    dataset_name = "resnet_features" if appearance else "resnext_features"
    if extractor is None:
        build = build_appearance_extractor if appearance else build_motion_extractor
        extractor = build(args.ckpt, dev, getattr(args, "compute_dtype", "float32"))

    # a pool of decoder threads (cv2 releases the GIL) feeding the device
    # in submission order; a decode failure is handed to the consumer
    q: queue.Queue = queue.Queue(maxsize=max(args.videos_per_batch * 2, args.decode_threads * 2))
    sentinel = object()

    def producer():
        from concurrent.futures import ThreadPoolExecutor

        def decode(item):
            path, vid = item
            return vid, decode_video_rgb(path), path

        try:
            with ThreadPoolExecutor(max_workers=max(args.decode_threads, 1)) as pool:
                for result in pool.map(decode, video_paths):
                    q.put(result)
        except BaseException as e:  # re-raised by the consumer
            q.put(e)
        q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()

    n = len(video_paths)
    t_start = time.monotonic()
    os.makedirs(os.path.dirname(os.path.abspath(args.outfile)), exist_ok=True)
    with h5py.File(args.outfile, "w") as fd:
        per_video = (args.num_clips, f, 2048) if appearance else (args.num_clips, 2048)
        feat_ds = fd.create_dataset(dataset_name, (n, *per_video), dtype=np.float32)
        ids_ds = fd.create_dataset("ids", (n,), dtype=np.int64)
        buf_vids, buf_clips = [], []
        written = 0

        def flush():
            nonlocal written
            if not buf_vids:
                return
            good = [c for c in buf_clips if c is not None]
            if good:
                batch = torch.cat(good, 0)
                if appearance:  # (V*C, F, 3, H, W) -> frames (V*C*F, 3, H, W)
                    batch = batch.reshape(-1, *batch.shape[2:])
                feats = extractor(batch).reshape(len(good), *per_video).cpu().numpy()
            k = 0
            for vid, clips in zip(buf_vids, buf_clips):
                # broken videos get zero FEATURES (reference :174, :188)
                if clips is None:
                    feat_ds[written] = 0.0
                else:
                    feat_ds[written] = feats[k]
                    k += 1
                ids_ds[written] = int(vid) if str(vid).isdigit() else hash(vid) % (2 ** 62)
                written += 1
            buf_vids.clear()
            buf_clips.clear()

        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            vid, frames, path = item
            if len(frames) == 0:
                print(f"file {path} error")
                clips = None
            else:
                clips = clips_from_frames(frames, args.num_clips, f, image_size, not appearance, dev)
            buf_vids.append(vid)
            buf_clips.append(clips)
            if len(buf_vids) >= args.videos_per_batch:
                flush()
                done = written
                per = (time.monotonic() - t_start) / max(done, 1)
                print(f"{done}/{n} videos, {per:.3f}s/video, ETA {per * (n - done):.0f}s", flush=True)
        flush()
    print(f"wrote {n} videos to {args.outfile}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--gpu_id", type=int, default=0, help="accepted for parity; unused")
    parser.add_argument("--dataset", default="svqa", choices=["svqa", "msvd-qa", "msrvtt-qa"])
    parser.add_argument("--model", default="resnet101", choices=["resnet101", "resnext101"])
    parser.add_argument("--num_clips", type=int, default=24)
    parser.add_argument("--image_height", type=int, default=224)
    parser.add_argument("--image_width", type=int, default=224)
    parser.add_argument("--annotation_file", type=str, required=True,
                        help="annotation json; may contain {mode} for msvd/msrvtt")
    parser.add_argument("--video_dir", type=str, required=True)
    parser.add_argument("--video_name_mapping", type=str, default="", help="msvd youtube_mapping.txt")
    parser.add_argument("--ckpt", type=str, default="",
                        help="torch .pth weights (torchvision resnet101 / Kinetics resnext-101)")
    parser.add_argument("--outfile", type=str, default="data/{dataset}/{dataset}_{type}_feat.h5")
    parser.add_argument("--videos_per_batch", type=int, default=4)
    parser.add_argument("--decode_threads", type=int, default=8)
    parser.add_argument("--seed", type=int, default=666)
    parser.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                        help="backbone inference dtype (bf16: convs and BatchNorm in bf16, fp32 features)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    resolve_device(args.device)

    if args.model == "resnet101":
        args.feature_type = "appearance"
    else:
        args.feature_type = "motion"
        args.image_height = args.image_width = 112

    args.outfile = args.outfile.format(dataset=args.dataset, type=args.feature_type)
    random.seed(args.seed)
    np.random.seed(args.seed)

    mod = {"svqa": svqa, "msvd-qa": msvd_qa, "msrvtt-qa": msrvtt_qa}[args.dataset]
    video_paths = mod.load_video_paths(args)
    random.shuffle(video_paths)  # the reference shuffles the processing order (:244)
    generate_h5(args, video_paths)


if __name__ == "__main__":
    main()
