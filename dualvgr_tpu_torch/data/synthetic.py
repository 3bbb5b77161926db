"""Synthetic dataset fixture: reference-shaped artifacts without downloads.

The port's own copy of the JAX package's ``data/synthetic.py``: for the same
seed and arguments it writes the same files (the pickles key by key, the
HDF5 arrays bit for bit, the vocab json, the YAML apart from its paths).
``h5py`` is imported only where the feature files are written.

Writes a complete {vocab json, train/val/test question pickles, appearance +
motion HDF5, experiment YAML} set whose schemas match the reference
byte-layout contracts (SURVEY.md section 1 artifact table; reference
preprocess/preprocess_features.py:158-198 and datautils/svqa.py:128-140), so
the full train/validate CLI path runs end-to-end in seconds on the CPU or the card.

The synthetic answers are made *learnable*: each video gets a latent class
whose signature is added to its features, and each question's answer is a
deterministic function of that class and the question's first token — so a
working model beats chance quickly, which smoke-tests learning, not just
plumbing.

Usage:  python -m dualvgr_tpu_torch.data.synthetic --out DIR [--dataset svqa]
        [--num-videos 60] [--questions-per-video 4] [--num-clips 8]
        [--vision-dim 2048] [--frames 16] [--answers 20] [--vocab 120]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


# id -> loader-side category-name (reference DataLoader.py:29-30 key set)
_LOADER_CATEGORY_NAMES = [
    "count", "exist", "query_color", "query_size", "query_actiontype",
    "query_actiondir", "query_shape", "greater_than", "equal_to",
    "less_than", "equal_color", "equal_size", "equal_actiontype",
    "equal_actiondir", "equal_shape",
]


def generate(
    out_dir: str,
    dataset: str = "svqa",
    num_videos: int = 60,
    questions_per_video: int = 4,
    num_clips: int = 8,
    vision_dim: int = 2048,
    frames: int = 16,
    num_answers: int = 20,
    vocab_size: int = 120,
    max_q_len: int = 12,
    word_dim: int = 300,
    seed: int = 0,
    module_dim: int = 96,
    batch_size: int = 32,
    max_epochs: int = 2,
    category_names: bool = False,
    label_noise: float = 0.0,
    eval_questions_per_video: int | None = None,
) -> dict:
    """Write all artifacts; returns {'config': path to the YAML, ...}.

    ``label_noise``: probability of replacing each question's answer with a
    uniformly-random DIFFERENT answer (deterministic under ``seed``, applied
    to every split). A noisy fixture makes accuracy plateau at roughly the
    clean-label fraction instead of saturating at 100% — parity claims
    measured at a sub-ceiling plateau actually discriminate between stacks,
    because any roughly-correct implementation saturates a noise-free
    fixture. The returned dict carries ``noise_stats`` and
    ``val_clean_fraction`` (the Bayes-style accuracy ceiling on val: a model
    that learns the true answer function exactly scores the clean fraction,
    since noisy val labels are unpredictable by construction).

    ``eval_questions_per_video``: question count per VAL/TEST video (train
    keeps ``questions_per_video``). Statistical-power knob: accuracy-parity
    deltas are gated at 0.2% absolute (BASELINE.md), so the eval split must
    be large enough for a binomial CI at that scale while the train split —
    whose size sets the training cost — stays small. ``None`` (default)
    keeps every split at ``questions_per_video`` and the byte-identical rng
    stream of pre-knob fixtures."""
    rng = np.random.RandomState(seed)
    os.makedirs(out_dir, exist_ok=True)
    name = dataset

    # --- vocab ---------------------------------------------------------
    question_token_to_idx = {"<NULL>": 0, "<UNK>": 1}
    # seed bucketing words used by the MSVD/MSRVTT validator (validate.py:68-80)
    for w in ["what", "who", "how", "when", "where"]:
        question_token_to_idx[w] = len(question_token_to_idx)
    for i in range(len(question_token_to_idx), vocab_size):
        question_token_to_idx[f"word{i}"] = i
    answer_token_to_idx = {"<UNK0>": 0, "<UNK1>": 1}
    for i in range(2, num_answers):
        answer_token_to_idx[f"ans{i}"] = i
    vocab = {
        "question_token_to_idx": question_token_to_idx,
        "answer_token_to_idx": answer_token_to_idx,
        "question_answer_token_to_idx": {"<NULL>": 0, "<UNK>": 1},
    }
    vocab_path = os.path.join(out_dir, f"{name}_vocab.json")
    with open(vocab_path, "w") as f:
        json.dump(vocab, f, indent=2)

    # --- features: latent-class-structured noise -----------------------
    video_ids = np.arange(num_videos, dtype=np.int64)
    latent = rng.randint(0, 4, size=num_videos)
    class_sig = rng.randn(4, vision_dim).astype(np.float32) * 2.0

    app = rng.randn(num_videos, num_clips, frames, vision_dim).astype(np.float32)
    app += class_sig[latent][:, None, None, :]
    mot = rng.randn(num_videos, num_clips, vision_dim).astype(np.float32)
    mot += class_sig[latent][:, None, :]

    import h5py

    app_path = os.path.join(out_dir, f"{name}_appearance_feat.h5")
    with h5py.File(app_path, "w") as f:
        f.create_dataset("resnet_features", data=app)
        f.create_dataset("ids", data=video_ids)
    mot_path = os.path.join(out_dir, f"{name}_motion_feat.h5")
    with h5py.File(mot_path, "w") as f:
        f.create_dataset("resnext_features", data=mot)
        f.create_dataset("ids", data=video_ids)

    # --- questions: answer = f(latent class, first token) --------------
    bucket_words = ["what", "who", "how", "when", "where"]
    glove = rng.randn(len(question_token_to_idx), word_dim).astype(np.float32) * 0.1

    noise_stats: dict = {}

    def make_split(mode: str, vids: np.ndarray, qid_start: int):
        qs, qlens, qids, vid_list, answers, cats = [], [], [], [], [], []
        qid = qid_start
        n_noised = 0
        qpv = questions_per_video
        if mode != "train" and eval_questions_per_video is not None:
            qpv = eval_questions_per_video
        for v in vids:
            for k in range(qpv):
                first = question_token_to_idx[bucket_words[k % len(bucket_words)]]
                length = int(rng.randint(3, max_q_len + 1))
                toks = [first] + list(
                    rng.randint(2, len(question_token_to_idx), size=length - 1)
                )
                row = np.zeros(max_q_len, np.int32)
                row[:length] = toks
                qs.append(row)
                qlens.append(length)
                qids.append(qid)
                vid_list.append(int(v))
                ans = 2 + (int(latent[v]) * len(bucket_words) + (k % len(bucket_words))) % (
                    num_answers - 2
                )
                # short-circuit keeps the rng stream (and thus every
                # artifact) byte-identical to pre-noise fixtures when
                # label_noise == 0
                if label_noise > 0.0 and rng.rand() < label_noise:
                    ans = 2 + (ans - 2 + int(rng.randint(1, num_answers - 2))) % (
                        num_answers - 2
                    )
                    n_noised += 1
                answers.append(ans)
                cat = int(rng.randint(0, 15))
                # category_names: store the loader-side string names
                # (reference DataLoader.py:29-30) instead of ints. The
                # reference's OWN pipeline is int-incompatible: its
                # preprocessing stores ints (svqa.py:95) but its loader maps
                # QUESTION_CATEGORY[category] with string keys
                # (DataLoader.py:65) and crashes on ints — string pickles
                # are the only form its loader can actually consume.
                cats.append(_LOADER_CATEGORY_NAMES[cat] if category_names else cat)
                qid += 1
        obj = {
            "questions": np.stack(qs),
            "questions_len": np.asarray(qlens, np.int32),
            "question_id": qids,
            "video_ids": np.asarray(vid_list),
            "video_names": np.asarray(vid_list),
            "answers": answers,
            "glove": glove if mode == "train" else None,
        }
        if dataset == "svqa":
            obj["question_category"] = cats
        path = os.path.join(out_dir, f"{name}_{mode}_questions.pt")
        with open(path, "wb") as f:
            pickle.dump(obj, f)
        noise_stats[mode] = {"noised": n_noised, "total": len(answers)}
        return qid

    n_train = int(num_videos * 0.7)
    n_val = int(num_videos * 0.15)
    qid = make_split("train", video_ids[:n_train], 0)
    qid = make_split("val", video_ids[n_train : n_train + n_val], qid)
    make_split("test", video_ids[n_train + n_val :], qid)

    # --- ready-to-run experiment YAML ----------------------------------
    cfg_path = os.path.join(out_dir, f"{name}_synth.yml")
    with open(cfg_path, "w") as f:
        f.write(
            f"""gpu_id: 0
multi_gpus: False
num_workers: 2
seed: 666
exp_name: 'expSynth-{name}'
model_type: 'DualVGR'
graph_module: 'GAT'
graph_layers: 1

train:
  lr: 0.001
  batch_size: {batch_size}
  restore: False
  max_epochs: {max_epochs}
  vision_dim: {vision_dim}
  word_dim: {word_dim}
  module_dim: {module_dim}
  glove: True
  num_of_nodes: {num_clips}

val:
  flag: True

test:
  test_num: 0
  write_preds: True

dataset:
  name: '{name}'
  data_dir: '{out_dir}'
  save_dir: '{os.path.join(out_dir, "results")}/'
"""
        )
    val_stats = noise_stats.get("val", {"noised": 0, "total": 1})
    return {
        "config": cfg_path,
        "vocab": vocab_path,
        "appearance": app_path,
        "motion": mot_path,
        "noise_stats": noise_stats,
        "val_clean_fraction": 1.0 - val_stats["noised"] / max(val_stats["total"], 1),
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--dataset", default="svqa", choices=["svqa", "msvd-qa", "msrvtt-qa"])
    p.add_argument("--num-videos", type=int, default=60)
    p.add_argument("--questions-per-video", type=int, default=4)
    p.add_argument("--num-clips", type=int, default=8)
    p.add_argument("--vision-dim", type=int, default=2048)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--answers", type=int, default=20)
    p.add_argument("--vocab", type=int, default=120)
    p.add_argument("--word-dim", type=int, default=300)
    p.add_argument("--module-dim", type=int, default=96)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-epochs", type=int, default=2)
    p.add_argument("--label-noise", type=float, default=0.0)
    p.add_argument("--eval-questions-per-video", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    paths = generate(
        args.out,
        dataset=args.dataset,
        num_videos=args.num_videos,
        questions_per_video=args.questions_per_video,
        num_clips=args.num_clips,
        vision_dim=args.vision_dim,
        frames=args.frames,
        num_answers=args.answers,
        vocab_size=args.vocab,
        word_dim=args.word_dim,
        module_dim=args.module_dim,
        batch_size=args.batch_size,
        max_epochs=args.max_epochs,
        label_noise=args.label_noise,
        eval_questions_per_video=args.eval_questions_per_video,
        seed=args.seed,
    )
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
