"""Vocabulary artifact reader (reference DataLoader.py:32-42).

The port's own copy of the JAX package's ``data/vocab.py``.
``{ds}_vocab.json`` holds ``question_token_to_idx``, ``answer_token_to_idx``
and ``question_answer_token_to_idx``; the loader adds the inverted maps the
validators use for question-type bucketing (reference validate.py:68-80).
"""

from __future__ import annotations

import json


def invert_dict(d: dict) -> dict:
    return {v: k for k, v in d.items()}


def load_vocab(path: str) -> dict:
    with open(path, "r") as f:
        vocab = json.load(f)
    vocab["question_idx_to_token"] = invert_dict(vocab["question_token_to_idx"])
    vocab["answer_idx_to_token"] = invert_dict(vocab["answer_token_to_idx"])
    vocab["question_answer_idx_to_token"] = invert_dict(vocab["question_answer_token_to_idx"])
    return vocab
