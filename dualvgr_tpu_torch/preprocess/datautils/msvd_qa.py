"""MSVD-QA adapter (reference preprocess/datautils/msvd_qa.py).

MSVD maps integer video ids through youtube_mapping.txt ("<yt_name> vid<k>"
pairs) to YouTubeClips/<yt_name>.avi files (msvd_qa.py:14-28).
"""

from __future__ import annotations

import json

from dualvgr_tpu_torch.preprocess.datautils import questions_common


def load_video_paths(args):
    video_ids = set()
    for mode in ["train", "val", "test"]:
        with open(args.annotation_file.format(mode), "r") as f:
            for inst in json.load(f):
                video_ids.add(inst["video_id"])
    with open(args.video_name_mapping, "r") as f:
        pairs = [line.split(" ") for line in f.read().split("\n") if line]
    mapping = {p[1]: p[0] for p in pairs}
    return [
        (args.video_dir + f"YouTubeClips/{mapping['vid' + str(vid)]}.avi", vid)
        for vid in video_ids
    ]


def process_questions(args):
    questions_common.process_questions(
        args,
        get_question=lambda inst: inst["question"],
        get_answer=lambda inst: inst["answer"],
        get_video_id=lambda inst: inst["video_id"],
    )
