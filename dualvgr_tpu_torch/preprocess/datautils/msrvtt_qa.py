"""MSRVTT-QA adapter (reference preprocess/datautils/msrvtt_qa.py).

Train/val videos live in TrainValVideo/, test in TestVideo/
(msrvtt_qa.py:10-26); files are ``video{id}.mp4``.
"""

from __future__ import annotations

import json

from dualvgr_tpu_torch.preprocess.datautils import questions_common


def load_video_paths(args):
    video_paths = []
    for mode in ["train", "val", "test"]:
        with open(args.annotation_file.format(mode), "r") as f:
            ids = {inst["video_id"] for inst in json.load(f)}
        subdir = "TrainValVideo" if mode in ("train", "val") else "TestVideo"
        video_paths.extend(
            (args.video_dir + f"{subdir}/video{vid}.mp4", vid) for vid in ids
        )
    return video_paths


def process_questions(args):
    questions_common.process_questions(
        args,
        get_question=lambda inst: inst["question"],
        get_answer=lambda inst: inst["answer"],
        get_video_id=lambda inst: inst["video_id"],
    )
