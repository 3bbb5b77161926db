"""Raw video + question -> ranked answers, on the card.

The port's counterpart of the JAX package's root ``predict.py``: clip
sampling, ResNet-101 appearance and ResNeXt-101 3D motion features, and
the DualVGR network, the features going straight from the backbones into
the reasoning network on the device (the reference splits this across two
offline CLIs and an HDF5 round trip).

    python -m dualvgr_tpu_torch.predict --cfg configs/msvd_qa_DualVGR.yml \\
        --video clip.mp4 --question "what is the man doing?" \\
        [--appearance_ckpt resnet101.pth --motion_ckpt resnext101.pth] \\
        [--unit_layers 1] [--topk 5] [--device cuda|cpu]

It restores the checkpoint that ``dualvgr_tpu_torch.train`` saved under
``{save_dir}/{exp_name}/ckpt``, as the port's validate CLI does, and reads
the dataset's vocab json. Backbone checkpoints are optional (seeded random
weights otherwise: useful only for smoke runs). Each video is decoded once
(cv2) and its 16 clips x 16 frames go through the appearance backbone in
one call; all videos' questions go through DualVGR in one forward. It runs
on the CUDA device unless ``--device cpu`` is given; there is no fallback.
``predict_frames`` is the same pipeline from decoded frames, which needs
no cv2. With the port's tracer on (``utils/trace.py``) a video records
the spans ``extract.upload``, ``extract.clips``, ``extract.appearance``
and ``extract.motion``, and a call ``predict.encode`` and
``predict.forward``, with the counters of the videos, frames, clips,
bytes and questions they took.
"""

from __future__ import annotations

import argparse
import copy
import os

import numpy as np
import torch

from dualvgr_tpu_torch.config import cfg_from_file
from dualvgr_tpu_torch.data.questions import encode_tokens, tokenize_question
from dualvgr_tpu_torch.export import model_from_checkpoint
from dualvgr_tpu_torch.preprocess.features import (
    FRAMES_PER_CLIP, build_appearance_extractor, build_motion_extractor, clips_from_frames, decode_video_rgb,
)
from dualvgr_tpu_torch.utils.device import resolve_device
from dualvgr_tpu_torch.utils.trace import count, span


def video_features(frames, app_extract, mot_extract, num_clips: int, appearance_size: int = 224,
                   motion_size: int = 112, device="cuda"):
    """One video's decoded ``frames`` ((T, H, W, 3) uint8) -> (appearance
    (num_clips, 16, 2048), motion (num_clips, 2048)) fp32 on the device.
    A video with no frames gives zero features, as the reference writes
    for a broken video."""
    dev = resolve_device(device)
    f = FRAMES_PER_CLIP
    if len(frames) == 0:
        return torch.zeros((num_clips, f, 2048), device=dev), torch.zeros((num_clips, 2048), device=dev)
    count("extract.videos")
    a_hw, m_hw = (appearance_size,) * 2, (motion_size,) * 2
    frames = torch.as_tensor(frames)
    count("extract.upload_bytes", frames.nbytes)
    with span("extract.upload"):
        frames = frames.to(dev)  # one uint8 copy serves both sizes
    with span("extract.clips"):
        clips_a = clips_from_frames(frames, num_clips, f, a_hw, False, dev)
        clips_m = clips_from_frames(frames, num_clips, f, m_hw, True, dev)
    app = app_extract(clips_a.reshape(num_clips * f, *clips_a.shape[2:])).reshape(num_clips, f, -1)
    return app, mot_extract(clips_m)


def encode_questions(questions, vocab) -> tuple[np.ndarray, np.ndarray]:
    """Questions as text -> (token ids (N, T) right-padded with 0, lengths
    (N,)); a question without its trailing '?' gets one first."""
    encoded = [encode_tokens(tokenize_question(q if q.endswith("?") else q + "?"), vocab["question_token_to_idx"])
               for q in questions]
    qlen = np.asarray([len(e) for e in encoded], np.int32)
    out = np.zeros((len(encoded), int(qlen.max())), np.int32)
    for i, e in enumerate(encoded):
        out[i, : len(e)] = e
    return out, qlen


def answer_logits(model, app, mot, questions, qlen) -> torch.Tensor:
    """DualVGR's logits (N, num_answers) for stacked features and encoded
    questions, one eval forward on the model's device."""
    dev = next(model.parameters()).device
    q = torch.as_tensor(questions, device=dev)
    ql = torch.as_tensor(qlen, device=dev)
    return model(app.to(dev), mot.to(dev), q, ql).logits


def predict_frames(frames_list, questions, *, model, vocab, app_extract, mot_extract, num_clips: int,
                   appearance_size: int = 224, motion_size: int = 112, device="cuda") -> torch.Tensor:
    """Decoded videos (one (T, H, W, 3) uint8 array a question) and their
    questions as text -> logits (N, num_answers) on the device."""
    by_video = {}  # a video asked several questions is extracted once
    for fr in frames_list:
        if id(fr) not in by_video:
            by_video[id(fr)] = video_features(fr, app_extract, mot_extract, num_clips, appearance_size,
                                              motion_size, device)
    feats = [by_video[id(fr)] for fr in frames_list]
    app = torch.stack([a for a, _ in feats])
    mot = torch.stack([m for _, m in feats])
    with span("predict.encode"):
        q, qlen = encode_questions(questions, vocab)
    count("predict.questions", len(questions))
    with span("predict.forward"):
        return answer_logits(model, app, mot, q, qlen)


def top_answers(logits: np.ndarray, answer_vocab, topk: int):
    """Per row: [(answer, probability)] of the ``topk`` largest logits."""
    out = []
    for row in logits:
        order = np.argsort(-row)[:topk]
        probs = np.exp(row - row.max())
        probs /= probs.sum()
        out.append([(answer_vocab[int(i)], float(probs[i])) for i in order])
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--video", required=True, nargs="+", help="video file(s)")
    p.add_argument("--question", required=True, nargs="+", help="question(s), quoted")
    p.add_argument("--unit_layers", type=int, default=1)
    p.add_argument("--appearance_ckpt", default="")
    p.add_argument("--motion_ckpt", default="")
    p.add_argument("--topk", type=int, default=5)
    # reduced resolutions as in the features CLI: random-weight smoke runs
    # (and the tests) do not need the full 224/112 cost
    p.add_argument("--appearance_size", type=int, default=224)
    p.add_argument("--motion_size", type=int, default=112)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if len(args.video) != len(args.question):
        if len(args.video) == 1:
            args.video = args.video * len(args.question)
        else:
            p.error("--video and --question counts must match (or one video)")
    dev = resolve_device(args.device)

    cfg = copy.deepcopy(cfg_from_file(args.cfg_file))
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    model, vocab = model_from_checkpoint(cfg, args.unit_layers, device=dev)
    num_clips = cfg.train.num_of_nodes  # clips == graph nodes

    app_extract = build_appearance_extractor(args.appearance_ckpt, dev)
    mot_extract = build_motion_extractor(args.motion_ckpt, dev)
    decoded = {path: decode_video_rgb(path) for path in dict.fromkeys(args.video)}
    for path, frames in decoded.items():
        if len(frames) == 0:
            print(f"WARNING: failed to decode {path}; using zero features")
    logits = predict_frames([decoded[v] for v in args.video], args.question, model=model, vocab=vocab,
                            app_extract=app_extract, mot_extract=mot_extract, num_clips=num_clips,
                            appearance_size=args.appearance_size, motion_size=args.motion_size,
                            device=dev).float().cpu().numpy()

    for i, (q, ranked) in enumerate(zip(args.question, top_answers(logits, vocab["answer_idx_to_token"],
                                                                    args.topk))):
        print(f"\nvideo: {args.video[i]}")
        print(f"Q: {q}")
        for rank, (ans, prob) in enumerate(ranked, 1):
            print(f"  {rank}. {ans}  (p={prob:.3f})")
    return logits


if __name__ == "__main__":
    main()
