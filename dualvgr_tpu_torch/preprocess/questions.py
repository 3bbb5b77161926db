"""Question-preprocessing CLI (reference preprocess/preprocess_questions.py).

The port's copy of the JAX package's ``preprocess/preprocess_questions.py``:
the same flags, vocab json and question pickles, tokenized without nltk.

    python -m dualvgr_tpu_torch.preprocess.questions --dataset svqa \
        --annotation_file /path/to/{mode}_qa.json --glove_pt glove.pickle \
        --mode train

Same flags as the reference plus ``--annotation_file`` (the reference
hardcodes absolute per-user annotation paths, preprocess_questions.py:24-36,
flagged TODO there; here it's a proper flag with the same {mode} templating).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dualvgr_tpu_torch.preprocess.datautils import msrvtt_qa, msvd_qa, svqa


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--dataset", default="svqa", choices=["msrvtt-qa", "msvd-qa", "svqa"], type=str
    )
    parser.add_argument("--answer_top", default=4000, type=int)
    parser.add_argument(
        "--glove_pt",
        help="glove pickle: {word: np.ndarray}; only needed in train mode",
    )
    parser.add_argument("--output_pt", type=str, default="data/{}/{}_{}_questions.pt")
    parser.add_argument("--vocab_json", type=str, default="data/{}/{}_vocab.json")
    parser.add_argument("--mode", choices=["train", "val", "test"], required=True)
    parser.add_argument(
        "--annotation_file",
        type=str,
        required=True,
        help="dataset annotation json; may contain {mode} (e.g. .../{mode}_qa.json)",
    )
    parser.add_argument("--seed", type=int, default=666)
    args = parser.parse_args(argv)
    np.random.seed(args.seed)
    args.annotation_file = args.annotation_file.format(mode=args.mode)

    out_dir = os.path.dirname(args.output_pt.format(args.dataset, args.dataset, args.mode))
    if out_dir and not os.path.exists(out_dir):
        os.makedirs(out_dir)

    {"msrvtt-qa": msrvtt_qa, "msvd-qa": msvd_qa, "svqa": svqa}[
        args.dataset
    ].process_questions(args)


if __name__ == "__main__":
    main()
