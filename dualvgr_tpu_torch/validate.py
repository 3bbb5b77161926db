"""Eval CLI: the reference CLI surface on the port.

Usage (the reference's flags, reference validate.py:238-242, plus the
device):
    python -m dualvgr_tpu_torch.validate --cfg configs/svqa_DualVGR_20.yml \\
        --unit_layers 1 [--device cuda|cpu]

The port's copy of the JAX package's root ``validate.py``: loads the best
checkpoint that ``dualvgr_tpu_torch.train`` saved under
``{save_dir}/{exp_name}/ckpt``, rebuilds the model from the saved
model_kwargs + the fresh vocab + ``--unit_layers`` (reference
validate.py:281-284), runs the test split, and prints overall and
per-category accuracy; with ``test.write_preds`` it writes
``preds/test_preds.json`` and prints 10 samples (validate.py:328-363). It
runs on the CUDA device unless ``--device cpu`` is given; there is no
fallback. Under a launcher (``torchrun --nproc_per_node N -m
dualvgr_tpu_torch.validate ...``) rank 0 reads the checkpoint and the
state is broadcast and placed as the config's ``tpu`` keys say; each rank
gathers and evaluates its rows of every test batch (the loader's
host-sharded mode), the predictions are gathered, and rank 0 alone writes
the predictions file.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import pickle
import sys

import torch.distributed as dist

from dualvgr_tpu_torch import train_lib, validate_lib
from dualvgr_tpu_torch.config import cfg_from_file, model_runtime_kwargs, resolve_dataset_paths
from dualvgr_tpu_torch.models.dualvgr import build_model as build_dualvgr
from dualvgr_tpu_torch.parallel.mesh import maybe_initialize_distributed
from dualvgr_tpu_torch.parallel.tp import mesh_for, place_state
from dualvgr_tpu_torch.train import host_sharding, make_loader
from dualvgr_tpu_torch.utils.checkpoint import load_model_kwargs, restore_checkpoint
from dualvgr_tpu_torch.utils.device import resolve_device
from dualvgr_tpu_torch.utils.logging import colored, setup_logging


def run(cfg, unit_layers: int, *, device="cuda", feature_stores=None):
    """Validate the best checkpoint of ``cfg`` (as ``cfg_from_file`` returns
    it) on its test split. ``feature_stores``: an optional (appearance,
    motion) pair of FeatureStores in place of the HDF5 files. Prints the
    accuracies and returns (acc, *category accuracies)."""
    maybe_initialize_distributed(device)
    dev = resolve_device(device)
    runtime = model_runtime_kwargs(cfg, dev)
    mesh = mesh_for(cfg, dev)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    cfg = copy.deepcopy(cfg)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    ckpt_dir = os.path.join(cfg.dataset.save_dir, "ckpt")
    if not os.path.exists(os.path.join(ckpt_dir, "model")):
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    cfg = resolve_dataset_paths(cfg)

    test_loader = make_loader(cfg, cfg.dataset.test_question_pt, shuffle=False, device=dev,
                              feature_stores=feature_stores, test_num=cfg.test.test_num,
                              **host_sharding(cfg, mesh))

    # rebuild the model from the saved kwargs + fresh vocab + CLI
    # unit_layers (reference validate.py:281-284)
    kw = load_model_kwargs(ckpt_dir)
    if "unit_layers" in kw and kw["unit_layers"] != unit_layers:
        # common with reference checkpoints, which hold 2 banks whatever
        # the training flag (the reference trainer never forwards
        # --unit_layers, reference train.py:58-66)
        logging.warning("checkpoint was saved with unit_layers=%d but --unit_layers=%d; restore will fail "
                        "unless they match", kw["unit_layers"], unit_layers)
    vocab = test_loader.vocab
    model = build_dualvgr(
        device=dev,
        seed=cfg.seed,
        vision_dim=kw["vision_dim"],
        module_dim=kw["module_dim"],
        word_dim=kw["word_dim"],
        question_vocab_size=len(vocab["question_token_to_idx"]),
        num_answers=len(vocab["answer_token_to_idx"]),
        num_of_nodes=kw["num_of_nodes"],
        graph_module=kw.get("graph_module", "GAT"),
        graph_layers=kw["graph_layers"],
        unit_layers=unit_layers,
        **runtime,
    )
    # the saved accumulation window's size depends on grad_accum: restore
    # with the config's, as training saved it
    optimizer = train_lib.make_optimizer(cfg.train.lr, len(test_loader),
                                         grad_accum=int(cfg.tpu.get("grad_accum", 1)))
    state = train_lib.create_train_state(model, optimizer, seed=cfg.seed)
    if rank0:  # the others take it from rank 0 in place_state
        _, state = restore_checkpoint(ckpt_dir, state)
    state = place_state(state, mesh)

    cat_names = validate_lib.category_names(cfg.dataset.name)
    out = validate_lib.validate(cfg, train_lib.pred_step, state, test_loader, write_preds=cfg.test.write_preds,
                                device=dev, prefetch=cfg.tpu.prefetch, mesh=mesh)
    if not rank0:
        return out if not cfg.test.write_preds else (out[0], *out[5:])
    if cfg.test.write_preds:
        acc, preds, gts, v_ids, q_ids, *cat_accs = out
    else:
        acc, *cat_accs = out

    sys.stdout.write("~~~~~~ Test Accuracy: {} ~~~~~~~\n".format(colored(f"{acc:.4f}", "red")))
    for nm, a in zip(cat_names, cat_accs):
        sys.stdout.write("    {} Accuracy: {}\n".format(nm, colored(f"{a:.4f}", "red")))
    sys.stdout.flush()

    if cfg.test.write_preds:
        # the preds JSON + 10 samples, with the reference's fields
        # (validate.py:328-363): video_id, question_id, video_name, the
        # decoded question tokens, answer, prediction
        out_dir = os.path.join(cfg.dataset.save_dir, "preds")
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, "test_preds.json")
        qvocab = vocab["question_idx_to_token"]
        with open(cfg.dataset.test_question_pt, "rb") as f:
            obj = pickle.load(f)
        by_qid = {str(qid): (name, q_row)
                  for qid, name, q_row in zip(obj["question_id"], obj["video_names"], obj["questions"])}
        instances = [
            {
                "video_id": v,
                "question_id": q,
                "video_name": str(by_qid[str(q)][0]),
                "question": [qvocab[int(w)] for w in by_qid[str(q)][1] if w != 0],
                "answer": gt,
                "prediction": p,
            }
            for v, q, gt, p in zip(v_ids, q_ids, gts, preds)
        ]
        with open(out_path, "w") as f:
            json.dump(instances, f)
        logging.info("wrote %d predictions to %s", len(instances), out_path)
        sys.stdout.write("Display 10 samples...\n")
        for inst in instances[:10]:
            sys.stdout.write("Video name: {}\nQuestion: {}?\nPrediction: {}\nGroundtruth: {}\n".format(
                inst["video_name"], " ".join(inst["question"]), inst["prediction"], inst["answer"]))
    return (acc, *cat_accs)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", dest="cfg_file", default="msvdqa_DualVGR.yml", type=str)
    parser.add_argument("--unit_layers", dest="unit_layers", default=1, type=int)
    parser.add_argument("--device", dest="device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    cfg = cfg_from_file(args.cfg_file)
    if cfg.dataset.name not in ("svqa", "msrvtt-qa", "msvd-qa"):
        raise ValueError(f"dataset.name must be svqa, msrvtt-qa or msvd-qa, got {cfg.dataset.name!r}")
    if not os.path.exists(cfg.dataset.data_dir):
        raise FileNotFoundError(f"dataset.data_dir {cfg.dataset.data_dir!r} does not exist")
    setup_logging()
    try:
        return run(cfg, args.unit_layers, device=args.device)[0]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
