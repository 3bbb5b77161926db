"""Dataset artifact integrity checker (the port's own copy of the JAX
package's ``data/check.py``).

Validates the offline-artifact contract the CLIs consume (SURVEY §1:
vocab json, question pickles, appearance/motion HDF5 pair — reference
preprocess writes them at svqa.py:128-140 / preprocess_features.py:158-198,
the loader reads them at DataLoader.py:71-74,95-147) and reports every
violation with a precise message, instead of the deep loader/model error a
user hits otherwise (e.g. migrating half-regenerated reference datasets).

    python -m dualvgr_tpu_torch.data.check --cfg configs/msvd_qa_DualVGR.yml

Exit code 0 = all artifacts consistent (warnings allowed), 1 = hard errors.
Library: ``check_dataset(...) -> (errors, warnings)``.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np


def _check_vocab(vocab_json: str, errors: list, warnings: list) -> dict | None:
    import json

    try:
        with open(vocab_json) as f:
            vocab = json.load(f)
    except (OSError, ValueError) as e:
        errors.append(f"vocab: cannot read {vocab_json}: {e}")
        return None
    for key in ("question_token_to_idx", "answer_token_to_idx",
                "question_answer_token_to_idx"):
        if key not in vocab:
            errors.append(f"vocab: missing key '{key}'")
    q = vocab.get("question_token_to_idx", {})
    if q.get("<NULL>") != 0 or q.get("<UNK>") != 1:
        errors.append(
            "vocab: question_token_to_idx must map <NULL>->0 and <UNK>->1 "
            f"(got {q.get('<NULL>')}, {q.get('<UNK>')}; svqa.py:44-47)"
        )
    for key in ("question_token_to_idx", "answer_token_to_idx"):
        ids = sorted((vocab.get(key) or {}).values())
        if ids and ids != list(range(len(ids))):
            errors.append(f"vocab: {key} indices are not contiguous 0..N-1")
    return vocab


def _check_questions(
    mode: str, path: str, vocab: dict | None, dataset: str,
    errors: list, warnings: list,
) -> np.ndarray | None:
    try:
        with open(path, "rb") as f:
            obj = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        errors.append(f"{mode}: cannot read {path}: {e}")
        return None
    tag = f"{mode} pickle"
    for key in ("questions", "questions_len", "question_id", "video_ids", "answers"):
        if key not in obj:
            errors.append(f"{tag}: missing key '{key}'")
            return None
    qs = np.asarray(obj["questions"])
    qlen = np.asarray(obj["questions_len"])
    vids = np.asarray(obj["video_ids"])
    ans = np.asarray(obj["answers"])
    n = len(qs)
    lengths_ok = True
    for name, arr in (("questions_len", qlen), ("video_ids", vids), ("answers", ans)):
        if len(arr) != n:
            errors.append(f"{tag}: len({name})={len(arr)} != len(questions)={n}")
            lengths_ok = False
    if qs.ndim != 2:
        errors.append(f"{tag}: questions must be 2-D padded (got shape {qs.shape})")
        return vids
    if n and len(qlen) and (qlen.min() < 1 or qlen.max() > qs.shape[1]):
        errors.append(
            f"{tag}: questions_len out of range [1, {qs.shape[1]}] "
            f"(min {qlen.min()}, max {qlen.max()})"
        )
    # <NULL>=0 padding beyond each row's true length (svqa.py:106-109) —
    # only checkable when the per-row lengths actually line up with the rows
    if n and lengths_ok:
        cols = np.arange(qs.shape[1])[None, :]
        if np.any(qs[cols >= qlen[:, None]] != 0):
            errors.append(
                f"{tag}: nonzero tokens beyond questions_len (padding must be <NULL>=0)"
            )
    if vocab:
        nq = len(vocab.get("question_token_to_idx", {}))
        na = len(vocab.get("answer_token_to_idx", {}))
        if nq and n and (qs.max() >= nq or qs.min() < 0):
            errors.append(
                f"{tag}: token ids outside [0, {nq}) (min {qs.min()}, max {qs.max()})"
            )
        if na and n and len(ans) and (ans.max() >= na or ans.min() < 0):
            errors.append(
                f"{tag}: answer ids outside [0, {na}) (min {ans.min()}, max {ans.max()})"
            )
    glove = obj.get("glove", None)
    if mode == "train":
        if glove is None:
            warnings.append(f"{tag}: no glove matrix (train.py:75-79 skips GloVe init)")
        elif vocab:
            g = np.asarray(glove)
            nq = len(vocab.get("question_token_to_idx", {}))
            if g.shape[0] != nq:
                errors.append(
                    f"{tag}: glove rows {g.shape[0]} != question vocab size {nq}"
                )
    if dataset == "svqa" and "question_category" not in obj:
        errors.append(f"{tag}: svqa requires question_category (svqa.py:95)")
    return vids


def _check_h5(
    path: str, dataset_name: str, want_rank: int,
    errors: list, warnings: list,
):
    import h5py

    try:
        f = h5py.File(path, "r")
    except OSError as e:
        errors.append(f"h5: cannot open {path}: {e}")
        return None, None
    with f:
        tag = os.path.basename(path)
        if dataset_name not in f:
            errors.append(f"{tag}: missing dataset '{dataset_name}'")
            return None, None
        if "ids" not in f:
            errors.append(f"{tag}: missing dataset 'ids'")
            return None, None
        shape = f[dataset_name].shape
        dtype = f[dataset_name].dtype
        ids = f["ids"][()]
        if len(shape) != want_rank:
            errors.append(
                f"{tag}: {dataset_name} rank {len(shape)} != {want_rank} "
                f"(shape {shape})"
            )
        if dtype != np.float32:
            warnings.append(f"{tag}: {dataset_name} dtype {dtype} (expected float32)")
        if len(ids) != shape[0]:
            errors.append(f"{tag}: len(ids)={len(ids)} != rows {shape[0]}")
        if len(set(ids.tolist())) != len(ids):
            errors.append(f"{tag}: duplicate video ids")
        return shape, set(str(i) for i in ids)


def check_dataset(
    vocab_json: str,
    question_pts: dict,
    appearance_feat: str,
    motion_feat: str,
    dataset: str = "svqa",
    num_of_nodes: int | None = None,
):
    """Returns (errors, warnings) — both lists of human-readable strings."""
    errors: list = []
    warnings: list = []
    vocab = _check_vocab(vocab_json, errors, warnings)

    app_shape, app_ids = _check_h5(
        appearance_feat, "resnet_features", 4, errors, warnings
    )
    mot_shape, mot_ids = _check_h5(motion_feat, "resnext_features", 3, errors, warnings)
    if app_shape and mot_shape and len(app_shape) == 4 and len(mot_shape) == 3:
        if app_shape[1] != mot_shape[1]:
            errors.append(
                f"h5: appearance clips {app_shape[1]} != motion clips {mot_shape[1]}"
            )
        if app_shape[3] != mot_shape[2]:
            errors.append(
                f"h5: appearance dim {app_shape[3]} != motion dim {mot_shape[2]}"
            )
        if num_of_nodes is not None and app_shape[1] != num_of_nodes:
            errors.append(
                f"h5: {app_shape[1]} clips but cfg.train.num_of_nodes="
                f"{num_of_nodes} (graph nodes ARE clips, SURVEY 2.1)"
            )

    for mode, path in question_pts.items():
        vids = _check_questions(mode, path, vocab, dataset, errors, warnings)
        if vids is None:
            continue
        for name, idset in (("appearance", app_ids), ("motion", mot_ids)):
            if idset is None:
                continue
            missing = [v for v in {str(v) for v in vids.tolist()} if v not in idset]
            if missing:
                errors.append(
                    f"{mode}: {len(missing)} video ids missing from the {name} "
                    f"h5 (first: {sorted(missing)[:5]})"
                )
    return errors, warnings


def main(argv=None) -> int:
    from dualvgr_tpu_torch.config import cfg_from_file, resolve_dataset_paths

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cfg", dest="cfg_file", required=True)
    args = p.parse_args(argv)

    cfg = cfg_from_file(args.cfg_file)
    cfg = resolve_dataset_paths(cfg)
    pts, missing = {}, []
    for mode in ("train", "val", "test"):
        path = getattr(cfg.dataset, f"{mode}_question_pt", "")
        if os.path.exists(path):
            pts[mode] = path
        else:
            missing.append((mode, path))
    if not pts:
        print("ERROR: no question pickles found at the configured paths")
        return 1
    errors, warnings = check_dataset(
        cfg.dataset.vocab_json, pts,
        cfg.dataset.appearance_feat, cfg.dataset.motion_feat,
        dataset=cfg.dataset.name, num_of_nodes=cfg.train.num_of_nodes,
    )
    # a half-regenerated dataset (some splits never rebuilt) is exactly the
    # failure mode this tool exists for — missing splits are hard errors
    errors += [f"{mode}: configured pickle does not exist: {p}" for mode, p in missing]
    for w in warnings:
        print(f"WARN: {w}")
    for e in errors:
        print(f"ERROR: {e}")
    print(
        f"checked {len(pts)} split(s): "
        + ("OK" if not errors else f"{len(errors)} error(s)")
    )
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
