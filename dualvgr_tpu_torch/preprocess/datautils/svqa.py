"""SVQA adapter (reference preprocess/datautils/svqa.py).

SVQA instances carry a functional program; the question category is the last
program step's function name (svqa.py:95), mapped through
QUESTION_CATEGORY_DICT (svqa.py:9-11). Video files are ``{id}.mp4``.
"""

from __future__ import annotations

import json

from dualvgr_tpu_torch.preprocess.datautils import questions_common

QUESTION_CATEGORY_DICT = {
    "count": 0, "exist": 1, "query_color": 2, "query_size": 3,
    "query_actiontype": 4, "query_direction": 5, "query_shape": 6,
    "compare_more": 7, "compare_equal": 8, "compare_less": 9,
    "attribute_compare_color": 10, "attribute_compare_size": 11,
    "attribute_compare_actiontype": 12, "attribute_compare_direction": 13,
    "attribute_compare_shape": 14,
}


def load_video_paths(args):
    """[(path, video_id)] for every video id in the annotation file."""
    with open(args.annotation_file, "r") as f:
        instances = json.load(f)
    video_ids = sorted({int(inst["id"]) for inst in instances})
    return [(args.video_dir + f"{vid}.mp4", vid) for vid in video_ids]


def process_questions(args):
    questions_common.process_questions(
        args,
        get_question=lambda inst: inst["question"],
        get_answer=lambda inst: inst["ans"],
        get_video_id=lambda inst: int(inst["id"]),
        get_category=lambda inst: QUESTION_CATEGORY_DICT[inst["program"][-1]["function"]],
    )
