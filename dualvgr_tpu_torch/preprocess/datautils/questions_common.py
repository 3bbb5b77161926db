"""Shared question-preprocessing core for all three datasets.

The port's own copy of the JAX package's ``preprocess/datautils/
questions_common.py``, on the port's tokenizer (``data/questions.py``:
nltk's Treebank tokenizer, without nltk) in place of ``nltk.word_tokenize``
(see that module for the few inputs on which the two differ).

The reference triplicates this logic across svqa/msvd_qa/msrvtt_qa
(reference preprocess/datautils/{svqa.py:26-140, msvd_qa.py:31-141,
msrvtt_qa.py:29-139}); the semantics here are identical per dataset:

* train mode builds the vocab: answers = <UNK0>:0/<UNK1>:1 + top
  ``answer_top`` by frequency; questions tokenized from
  ``question.lower()[:-1]`` (the trailing character — the question mark —
  is stripped BEFORE tokenization), <NULL>:0/<UNK>:1,
* every question is encoded, right-padded with <NULL> to the split max,
* out-of-vocab answers map to 0 in train and 1 in val/test,
* train mode aligns a GloVe matrix to the question vocab (zeros for OOV),
* output pickle keys: questions, questions_len, question_id, video_ids,
  video_names, answers, glove (+ question_category for SVQA).
"""

from __future__ import annotations

import json
import pickle
from collections import Counter

import numpy as np

from dualvgr_tpu_torch.data.questions import encode_tokens, tokenize_question


def build_vocab(instances, get_question, get_answer, answer_top: int) -> dict:
    answer_cnt = Counter(get_answer(inst) for inst in instances)
    answer_token_to_idx = {"<UNK0>": 0, "<UNK1>": 1}
    frequent = answer_cnt.most_common(answer_top)
    total = sum(answer_cnt.values())
    total_freq = sum(c for _, c in frequent)
    print("Number of unique answers:", len(answer_cnt))
    print("Total number of answers:", total)
    print("Top %i answers account for %f%%" % (len(frequent), total_freq * 100.0 / max(total, 1)))
    for token, _ in frequent:
        answer_token_to_idx[token] = len(answer_token_to_idx)

    question_token_to_idx = {"<NULL>": 0, "<UNK>": 1}
    for inst in instances:
        for token in tokenize_question(get_question(inst)):
            if token not in question_token_to_idx:
                question_token_to_idx[token] = len(question_token_to_idx)

    return {
        "question_token_to_idx": question_token_to_idx,
        "answer_token_to_idx": answer_token_to_idx,
        "question_answer_token_to_idx": {"<NULL>": 0, "<UNK>": 1},
    }


def build_glove_matrix(vocab: dict, glove_pt: str) -> np.ndarray:
    token_itow = {i: w for w, i in vocab["question_token_to_idx"].items()}
    print("Load glove from %s" % glove_pt)
    with open(glove_pt, "rb") as f:
        glove = pickle.load(f)
    dim_word = glove["the"].shape[0]
    rows = [
        glove.get(token_itow[i], np.zeros((dim_word,)))
        for i in range(len(token_itow))
    ]
    return np.asarray(rows, dtype=np.float32)


def process_questions(
    args,
    get_question,
    get_answer,
    get_video_id,
    get_category=None,
):
    """Full per-split pipeline; writes the vocab json (train) + pickle."""
    print("Loading data")
    with open(args.annotation_file, "r") as f:
        instances = json.load(f)

    vocab_path = args.vocab_json.format(args.dataset, args.dataset)
    if args.mode in ["train"]:
        print("Building vocab")
        vocab = build_vocab(instances, get_question, get_answer, args.answer_top)
        print("Write into %s" % vocab_path)
        with open(vocab_path, "w") as f:
            json.dump(vocab, f, indent=4)
    else:
        print("Loading vocab")
        with open(vocab_path, "r") as f:
            vocab = json.load(f)

    print("Encoding data")
    questions_encoded, questions_len = [], []
    question_ids, video_ids, video_names = [], [], []
    all_answers, categories = [], []
    for idx, inst in enumerate(instances):
        tokens = tokenize_question(get_question(inst))
        encoded = encode_tokens(tokens, vocab["question_token_to_idx"])
        questions_encoded.append(encoded)
        questions_len.append(len(encoded))
        question_ids.append(idx)
        vid = get_video_id(inst)
        video_ids.append(vid)
        video_names.append(vid)
        answer_str = get_answer(inst)
        if answer_str in vocab["answer_token_to_idx"]:
            answer = vocab["answer_token_to_idx"][answer_str]
        elif args.mode in ["train"]:
            answer = 0
        else:  # val/test OOV answers -> <UNK1>
            answer = 1
        all_answers.append(answer)
        if get_category is not None:
            categories.append(get_category(inst))

    max_len = max(len(x) for x in questions_encoded)
    null = vocab["question_token_to_idx"]["<NULL>"]
    for qe in questions_encoded:
        while len(qe) < max_len:
            qe.append(null)

    questions_encoded = np.asarray(questions_encoded, dtype=np.int32)
    questions_len = np.asarray(questions_len, dtype=np.int32)
    print(questions_encoded.shape)

    glove_matrix = None
    if args.mode == "train":
        glove_matrix = build_glove_matrix(vocab, args.glove_pt)
        print(glove_matrix.shape)

    obj = {
        "questions": questions_encoded,
        "questions_len": questions_len,
        "question_id": question_ids,
        "video_ids": np.asarray(video_ids),
        "video_names": np.array(video_names),
        "answers": all_answers,
        "glove": glove_matrix,
    }
    if get_category is not None:
        obj["question_category"] = categories

    out_path = args.output_pt.format(args.dataset, args.dataset, args.mode)
    print("Writing", out_path)
    with open(out_path, "wb") as f:
        pickle.dump(obj, f)
