"""Validation with per-question-type accuracy splits.

The port's own copy of the JAX package's ``validate_lib.py`` (a behavioral
port of reference validate.py:23-235):

* MSVD-QA / MSRVTT-QA: 5-way buckets by the question's FIRST token —
  what/who/how/when/where, looked up through the vocab's inverted map
  (validate.py:61-80);
* SVQA: 15-way buckets by the stored ``question_category`` id, named per
  the id->name map at validate.py:18-21;
* the same tuple orders as the reference (validate.py:226-235), with the
  optional write_preds extras (decoded answer strings, ground truths,
  video/question ids — validate.py:133-146).

Padded rows (``valid == 0``) are left out of every count. An empty bucket's
accuracy is 0.0, where the reference divides by zero.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from dualvgr_tpu_torch.parallel.comm import all_gather_cat
from dualvgr_tpu_torch.parallel.mesh import mesh_axis, prefetch_to_device
from dualvgr_tpu_torch.utils.device import resolve_device
from dualvgr_tpu_torch.utils.trace import span

SVQA_CATEGORY_NAMES = [
    "count", "exist", "query_color", "query_size", "query_actiontype",
    "query_direction", "query_shape", "compare_more", "compare_equal",
    "compare_less", "attribute_compare_color", "attribute_compare_size",
    "attribute_compare_actiontype", "attribute_compare_direction",
    "attribute_compare_shape",
]

MSVD_BUCKETS = ["what", "who", "how", "when", "where"]


def _safe_div(a, b):
    return float(a) / float(b) if b else 0.0


def validate(cfg, eval_fn, state, loader, write_preds: bool = False, device="cuda", prefetch: int = 2,
             mesh=None):
    """Run a full eval pass.

    eval_fn(state, (app, motion, question, qlen)) -> logits (B, A) or
    already-argmaxed predictions (B,), tensors or numpy (``train_lib.
    pred_step`` is the one to use: only B ints cross to the host per batch).
    Batches come from a VideoQADataLoader; their inputs are copied to
    ``device`` ``prefetch`` batches ahead (``prefetch_to_device``; on the
    CPU a pass-through). ``device`` is the card unless the caller names the
    CPU, and CUDA asked for on a machine without it raises
    (``resolve_device``). With ``mesh`` (every rank of it calls this) the
    loader is host-sharded over the data axis ``cfg.tpu.mesh_axis``
    (``host_count`` the axis's size): each rank gathers, copies and
    evaluates only its rows of each global batch, and the predictions and
    the rows' small fields (answer, valid, first token, category, ids) are
    all-gathered, so every rank counts the whole batch.
    Returns reference-ordered tuples (validate.py:226-235).
    """
    device = resolve_device(device)
    axis = mesh_axis(mesh, cfg.tpu.mesh_axis) if mesh is not None else None
    if axis is not None and getattr(loader, "host_count", 1) != axis.size:
        raise ValueError(f"validation on a data axis of {axis.size} needs a loader sharded over it "
                         f"(host_count {getattr(loader, 'host_count', 1)})")
    name = cfg.dataset.name
    all_agree, all_preds_idx, all_gts_idx = [], [], []
    all_first_tok, all_cats, all_vids, all_qids = [], [], [], []

    pending = collections.deque()  # host batches, in the order of their inputs

    def host_inputs():
        for b in loader:
            pending.append(b)
            yield (b.appearance_feat, b.motion_feat, b.question, b.question_len)

    for inputs in prefetch_to_device(host_inputs(), device, prefetch, local=axis is not None):
        batch = pending.popleft()
        out = eval_fn(state, inputs)
        with span("validate.fetch"):
            if axis is not None:
                preds, batch = _gather_rows(out, batch, axis, device)
            else:
                out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
                preds = out.argmax(1) if out.ndim == 2 else out
        keep = batch.valid > 0
        all_agree.append((preds == batch.answer)[keep])
        all_preds_idx.append(preds[keep])
        all_gts_idx.append(batch.answer[keep])
        all_first_tok.append(batch.question[keep, 0])
        if batch.question_category is not None:
            all_cats.append(batch.question_category[keep])
        all_vids.append(batch.video_idx[keep])
        all_qids.append(batch.question_idx[keep])

    with span("validate.tally"):
        agree = np.concatenate(all_agree)
        acc = _safe_div(agree.sum(), len(agree))

        if name in ("msvd-qa", "msrvtt-qa"):
            # first-token bucketing through the vocab (validate.py:61-80)
            itos = loader.vocab["question_idx_to_token"]
            first = np.concatenate(all_first_tok)
            cat_accs = []
            for word in MSVD_BUCKETS:
                mask = np.asarray([itos.get(int(t)) == word for t in first], dtype=bool)
                cat_accs.append(_safe_div(agree[mask].sum(), mask.sum()))
        else:
            cats = np.concatenate(all_cats)
            cat_accs = [_safe_div(agree[cats == c].sum(), (cats == c).sum()) for c in range(15)]

        if not write_preds:
            return (acc, *cat_accs)

        answer_vocab = loader.vocab["answer_idx_to_token"]
        preds_idx = np.concatenate(all_preds_idx)
        gts_idx = np.concatenate(all_gts_idx)
        all_pred_strs = [answer_vocab[int(p)] for p in preds_idx]
        gt_strs = [answer_vocab[int(g)] for g in gts_idx]
        v_ids = [int(v) for v in np.concatenate(all_vids)]
        q_ids = [int(q) for q in np.concatenate(all_qids)]
        return (acc, all_pred_strs, gt_strs, v_ids, q_ids, *cat_accs)


def _gather_rows(out, batch, axis, device):
    """This rank's predictions and the small fields of its rows of a batch,
    all-gathered over ``axis``: the global batch's, in row order (rank r
    holds block r). Returns (predictions, the batch with those fields
    whole; its features stay this rank's)."""
    preds = torch.as_tensor(out, device=device)
    preds = preds.argmax(1) if preds.ndim == 2 else preds
    cat = batch.question_category if batch.question_category is not None else np.zeros_like(batch.answer)
    cols = (batch.answer, batch.valid, batch.question[:, 0], cat, batch.video_idx, batch.question_idx)
    local = torch.stack([preds.to(torch.int64)] + [torch.as_tensor(np.asarray(c), device=device).to(torch.int64)
                                                    for c in cols], 1)
    whole = all_gather_cat(local, axis, 0).cpu().numpy()
    return whole[:, 0], batch._replace(
        answer=whole[:, 1].astype(batch.answer.dtype), valid=whole[:, 2].astype(batch.valid.dtype),
        question=whole[:, 3:4].astype(batch.question.dtype),
        question_category=None if batch.question_category is None else whole[:, 4].astype(cat.dtype),
        video_idx=whole[:, 5], question_idx=whole[:, 6])


def category_names(dataset_name: str):
    return MSVD_BUCKETS if dataset_name in ("msvd-qa", "msrvtt-qa") else SVQA_CATEGORY_NAMES
