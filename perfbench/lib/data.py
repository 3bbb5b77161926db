"""The inputs of a run, made from its seed: clip features, questions,
answers and the vocabulary, at a configuration's published dataset scale.

Features are drawn on the device with a ``torch.Generator`` in chunks and
copied into one host tensor per stream, which the program's
``FeatureStore.from_array`` wraps without a copy, so its gather reads host
memory as it does from a cached feature file. The same host tensors are
the raw data the reference reads. Questions are drawn on the host: every
seed gets the same multiset of lengths (quantiles of the configuration's
length distribution) in another order, so the seed moves the order of the
work and not its amount.
"""

from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from perfbench.lib.common import sub_seed

WH_WORDS = ("what", "who", "how", "when", "where")  # the validation's question-type buckets
CHUNK_BYTES = 1 << 30


@dataclass
class Split:
    app: torch.Tensor  # (videos, clips, frames, vision_dim) float32, host
    mot: torch.Tensor  # (videos, clips, vision_dim) float32, host
    video_ids: np.ndarray  # (questions,) int64: the video row of each question
    questions: np.ndarray  # (questions, question_len) int32, right-padded with 0
    lengths: np.ndarray  # (questions,) int32
    answers: np.ndarray  # (questions,) int32
    starts: np.ndarray  # (videos + 1,) the first question of each video
    vocab: dict

    @property
    def num_questions(self) -> int:
        return len(self.answers)


def vocabulary(model: dict) -> dict:
    q = {"<NULL>": 0, "<UNK>": 1}
    for w in WH_WORDS:
        q[w] = len(q)
    while len(q) < model["question_vocab_size"]:
        q[f"w{len(q)}"] = len(q)
    answers = {f"a{i}": i for i in range(model["num_answers"])}
    return {"question_token_to_idx": q, "answer_token_to_idx": answers, "question_answer_token_to_idx": q}


def _features(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    host = torch.empty(shape, dtype=torch.float32)
    host.zero_()  # the pages faulted in by torch's threads, not one by one under the copy
    per_row = int(np.prod(shape[1:])) * 4
    step = max(1, CHUNK_BYTES // per_row)
    for lo in range(0, shape[0], step):
        hi = min(lo + step, shape[0])
        host[lo:hi].copy_(torch.randn((hi - lo, *shape[1:]), generator=gen, device=device))
    return host


def question_lengths(n: int, dist: dict) -> np.ndarray:
    """The ``n`` quantiles of ``offset + LogNormal(log_mean, log_sigma)``,
    rounded and clipped to [offset, max]."""
    p = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    x = dist["offset"] + torch.exp(dist["log_mean"] + dist["log_sigma"] * torch.special.ndtri(p))
    return np.clip(np.rint(x.numpy()), dist["offset"], dist["max"]).astype(np.int32)


def make_split(config: dict, split: str, seed: int, device, *, videos=None, questions=None) -> Split:
    """The ``split`` ("train" or "test") of ``config`` from ``seed``."""
    m = config["model"]
    n_v = videos or config[f"{split}_videos"]
    n_q = questions or config[f"{split}_questions"]
    c, f, v = m["num_of_nodes"], m["frames_per_clip"], m["vision_dim"]
    app = _features((n_v, c, f, v), sub_seed(seed, f"{split}.appearance"), device)
    mot = _features((n_v, c, v), sub_seed(seed, f"{split}.motion"), device)

    rng = np.random.default_rng(sub_seed(seed, f"{split}.questions"))
    per_video = np.full(n_v, n_q // n_v)
    per_video[rng.permutation(n_v)[: n_q % n_v]] += 1
    starts = np.concatenate([[0], np.cumsum(per_video)])
    video_ids = np.repeat(np.arange(n_v, dtype=np.int64), per_video)
    lengths = rng.permutation(question_lengths(n_q, config["question_length"]))
    t = m["question_len"]
    vocab = vocabulary(m)
    tokens = rng.integers(len(WH_WORDS) + 2, m["question_vocab_size"], size=(n_q, t), dtype=np.int64)
    shares = np.asarray([config["first_token_share"][w] for w in WH_WORDS], dtype=np.float64)
    tokens[:, 0] = 2 + rng.choice(len(WH_WORDS), size=n_q, p=shares / shares.sum())
    tokens[np.arange(t)[None, :] >= lengths[:, None]] = 0
    answers = rng.integers(0, m["num_answers"], size=n_q, dtype=np.int64)
    return Split(app, mot, video_ids, tokens.astype(np.int32), lengths.astype(np.int32),
                 answers.astype(np.int32), starts, vocab)


def write_files(split: Split, directory: str, name: str) -> tuple[str, str]:
    """The question pickle and vocabulary JSON that the program's loader
    reads (the published preprocessing's keys), under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    question_pt = os.path.join(directory, f"{name}_questions.pt")
    vocab_json = os.path.join(directory, f"{name}_vocab.json")
    with open(question_pt, "wb") as fh:
        pickle.dump({
            "questions": split.questions, "questions_len": split.lengths,
            "question_id": np.arange(split.num_questions, dtype=np.int64),
            "video_ids": split.video_ids, "answers": split.answers,
        }, fh)
    with open(vocab_json, "w") as fh:
        json.dump(split.vocab, fh)
    return question_pt, vocab_json


def batch_of(split: Split, question_ids, device) -> tuple:
    """(app, mot, q, qlen, answers) of the questions ``question_ids``,
    gathered by the harness itself from the raw data, on ``device``."""
    idx = torch.as_tensor(np.asarray(question_ids, dtype=np.int64))
    rows = torch.as_tensor(split.video_ids)[idx]
    return (split.app.index_select(0, rows).to(device), split.mot.index_select(0, rows).to(device),
            torch.as_tensor(split.questions)[idx].to(device), torch.as_tensor(split.lengths)[idx].to(device),
            torch.as_tensor(split.answers)[idx].to(device))
