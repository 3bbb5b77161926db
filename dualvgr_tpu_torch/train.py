"""Train CLI: the reference CLI surface on the port.

Usage (the reference's four flags, reference train.py:370-376, plus the
device):
    python -m dualvgr_tpu_torch.train --cfg configs/svqa_DualVGR_20.yml \\
        --alpha 1 --beta 1e-8 --unit_layers 1 [--device cuda|cpu]

The port's copy of the JAX package's root ``train.py`` (its lines 73-355):
path templating under ``save_dir/exp_name``, seeding, the loaders, GloVe
injection, the epoch loop with the colored ticker every ``tpu.log_every``
steps, CE + alpha * common + beta * HSIC, clip 12, Adam with the lr halved
every 10 epochs (``tpu.grad_accum`` micro-steps per update), per-epoch
validation with per-category accuracy, a best-on-val checkpoint, an
autosave at every epoch end and on SIGTERM/SIGINT at the next step
(deleted on a clean finish), the ``tpu.metrics_jsonl`` stream and, with
``tpu.profile_dir``, a ``torch.profiler`` Chrome trace of the second
epoch and its validation, with the program's spans (``utils/trace.py``,
the loader's producer thread's too) over the kernels they launched and
the epoch's loader and copy counters logged. It runs on the
CUDA device unless ``--device cpu`` is given; there is no fallback.
``graph_module`` is "GCN" (the config default) or "GAT"; any other raises
the JAX package's ValueError.

On several GPUs, one process each:

    torchrun --nproc_per_node N -m dualvgr_tpu_torch.train --cfg ... [--device cuda|cpu]

As the JAX train.py does (its lines 78-98), the distributed bring-up comes
first (``parallel.maybe_initialize_distributed``: NCCL on CUDA, gloo on the
CPU), then the mesh (``parallel.mesh_for``: data parallel, or (data, model)
under ``tpu.tensor_parallel``), then the loaders in their host-sharded mode
(each rank gathers only its rows of every global batch), then the
state, restored on rank 0 alone and placed on the mesh
(``parallel.place_state``, ZeRO-1 under ``tpu.zero_opt``). Validation
evaluates each rank's rows of every global batch and gathers the
predictions. Rank 0 alone writes the checkpoints, the metrics stream, the ticker and
the profile; a checkpoint is gathered by every rank and the others wait
at a barrier until it is written.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import signal
import sys
import threading

import numpy as np
import torch
import torch.distributed as dist

from dualvgr_tpu_torch import train_lib, validate_lib
from dualvgr_tpu_torch.config import cfg_from_file, model_runtime_kwargs, resolve_dataset_paths
from dualvgr_tpu_torch.data import VideoQADataLoader
from dualvgr_tpu_torch.models.dualvgr import DualVGR
from dualvgr_tpu_torch.models.dualvgr import build_model as build_dualvgr
from dualvgr_tpu_torch.parallel.mesh import maybe_initialize_distributed, prefetch_to_device, process_batch_bounds
from dualvgr_tpu_torch.parallel.tp import mesh_for, place_state
from dualvgr_tpu_torch.utils import trace
from dualvgr_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint, saved_epoch
from dualvgr_tpu_torch.utils.device import resolve_device
from dualvgr_tpu_torch.utils.logging import MetricsWriter, setup_logging, train_ticker


def build_model(cfg, vocab, device) -> DualVGR:
    return build_dualvgr(
        device=device,
        seed=cfg.seed,
        graph_module=cfg.graph_module,
        vision_dim=cfg.train.vision_dim,
        module_dim=cfg.train.module_dim,
        word_dim=cfg.train.word_dim,
        question_vocab_size=len(vocab["question_token_to_idx"]),
        num_answers=len(vocab["answer_token_to_idx"]),
        num_of_nodes=cfg.train.num_of_nodes,
        graph_layers=cfg.graph_layers,
        unit_layers=cfg.unit_layers,
        **model_runtime_kwargs(cfg, device),
    )


def model_kwargs_tosave(cfg) -> dict:
    # reference saves model_kwargs minus vocab (train.py:67)
    return {
        "vision_dim": cfg.train.vision_dim,
        "module_dim": cfg.train.module_dim,
        "word_dim": cfg.train.word_dim,
        "num_of_nodes": cfg.train.num_of_nodes,
        "graph_module": cfg.graph_module,
        "graph_layers": cfg.graph_layers,
        "unit_layers": cfg.unit_layers,
    }


def make_loader(cfg, question_pt, *, shuffle, device, feature_stores=None, **num):
    """A VideoQADataLoader on the config's artifacts (or on
    ``feature_stores``, an (appearance, motion) pair of FeatureStores),
    pinned for a CUDA device; ``num`` takes the head truncations and the
    host-sharded mode's ``host_index`` and ``host_count``."""
    app, motion = feature_stores or (cfg.dataset.appearance_feat, cfg.dataset.motion_feat)
    return VideoQADataLoader(
        question_pt=question_pt,
        vocab_json=cfg.dataset.vocab_json,
        appearance_feat=app,
        motion_feat=motion,
        batch_size=cfg.train.batch_size,
        shuffle=shuffle,
        num_workers=cfg.num_workers,
        seed=cfg.seed,
        feature_cache_gb=cfg.tpu.feature_cache_gb,
        prefetch=cfg.tpu.prefetch,
        transfer_dtype=cfg.tpu.transfer_dtype,
        pin_memory=torch.device(device).type == "cuda",
        **num,
    )


def host_sharding(cfg, mesh) -> dict:
    """The loaders' host-sharded mode on ``mesh``: ``host_index`` and
    ``host_count`` such that this rank gathers its block of every global
    batch along the data axis ``tpu.mesh_axis``; {} without a mesh."""
    if mesh is None:
        return {}
    lo, hi = process_batch_bounds(mesh, cfg.tpu.mesh_axis, cfg.train.batch_size)
    logging.info("host-sharded loading: rows [%d, %d) of each global batch", lo, hi)
    return dict(host_index=lo // (hi - lo), host_count=cfg.train.batch_size // (hi - lo))


def _write_profile(profiler, profile_dir: str, epoch: int) -> None:
    """Ends the profiled epoch: the tracer off, the profiler stopped, its
    Chrome trace written, the epoch's counters logged."""
    trace.disable()
    trace.spans()  # the Chrome trace holds them
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace_epoch{epoch}.json")
    profiler.export_chrome_trace(path)
    logging.info("wrote profiler trace to %s; the epoch's counters: %s", path, trace.counters())


def train(cfg, stop_event=None, *, device="cuda", feature_stores=None):
    """Train from ``cfg`` (save_dir already under exp_name, dataset paths
    resolved: what ``main`` does). ``stop_event`` (threading.Event)
    requests a preemption-safe stop: the loop autosaves at the next step
    and returns. ``feature_stores``: an optional (appearance, motion) pair
    of FeatureStores handed to every loader in place of the HDF5 files.
    Returns (best val accuracy, train state)."""
    # distributed bring-up first: the host-sharded loader needs the mesh
    if maybe_initialize_distributed(device):
        logging.info("process group up: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
                     dist.get_backend())
    dev = resolve_device(device)
    logging.info("device: %s", torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev)
    mesh = mesh_for(cfg, dev)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if mesh is not None:
        logging.info("device mesh: %s", dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    sharding = host_sharding(cfg, mesh)

    logging.info("Create train_loader and val_loader.........")
    train_loader = make_loader(cfg, cfg.dataset.train_question_pt, shuffle=True, device=dev,
                               feature_stores=feature_stores, train_num=cfg.train.train_num, **sharding)
    logging.info("number of train instances: %d", train_loader.num_samples)
    val_loader = None
    if cfg.val.flag:
        val_loader = make_loader(cfg, cfg.dataset.val_question_pt, shuffle=False, device=dev,
                                 feature_stores=feature_stores, val_num=cfg.val.val_num, **sharding)
        logging.info("number of val instances: %d", val_loader.num_samples)

    logging.info("Create model.........")
    model = build_model(cfg, train_loader.vocab, dev)

    steps_per_epoch = len(train_loader)
    grad_accum = int(cfg.tpu.get("grad_accum", 1))
    optimizer = train_lib.make_optimizer(cfg.train.lr, steps_per_epoch, grad_accum=grad_accum)
    if grad_accum > 1:
        logging.info("gradient accumulation: %d micro-batches per update (effective batch %d)",
                     grad_accum, grad_accum * cfg.train.batch_size)
    state = train_lib.create_train_state(model, optimizer, seed=cfg.seed)
    logging.info("num of params: %d", sum(p.numel() for p in model.parameters()))

    if cfg.train.glove and train_loader.glove_matrix is not None:
        logging.info("load glove vectors")
        state = train_lib.set_glove(state, train_loader.glove_matrix)

    start_epoch = 0
    ckpt_dir = os.path.join(cfg.dataset.save_dir, "ckpt")
    autosave_dir = ckpt_dir + "_autosave"
    if cfg.train.restore:
        logging.info("Restore checkpoint and optimizer...")
        # prefer the autosave when it is at least as new as the best-val
        # checkpoint (a preempted or crashed run leaves one behind; a
        # cleanly finished run deletes it)
        best_ep, auto_ep = saved_epoch(ckpt_dir), saved_epoch(autosave_dir)
        if auto_ep is not None and (best_ep is None or auto_ep >= best_ep):
            restore_dir = autosave_dir
            logging.info("resuming from autosave (epoch %d)", auto_ep)
        elif best_ep is not None:
            restore_dir = ckpt_dir
        else:
            raise FileNotFoundError(
                f"train.restore is True but no checkpoint exists under {ckpt_dir} or {autosave_dir} "
                "(best checkpoints are only written when validation accuracy improves)"
            )
        # rank 0 reads the state; place_state broadcasts it
        epoch = restore_checkpoint(restore_dir, state)[0] if rank0 else saved_epoch(restore_dir)
        # the restored epoch replays from its start: a partly filled
        # grad-accum window would count its samples twice; drop it
        state = train_lib.reset_grad_accum(state)
        start_epoch = epoch + 1
    state = place_state(state, mesh, zero_opt=bool(cfg.tpu.get("zero_opt", False)))

    best_val = 0.0
    best_cats = None
    cat_names = validate_lib.category_names(cfg.dataset.name)
    prefetch = cfg.tpu.prefetch
    profile_dir = cfg.tpu.get("profile_dir", "")
    profiler = None
    autosave_on = bool(cfg.tpu.get("autosave", True))
    preempted = False

    def _autosave(save_epoch: int, why: str):
        save_checkpoint(autosave_dir, save_epoch, state, model_kwargs_tosave(cfg))
        logging.info("autosaved train state (%s, resume epoch %d)", why, save_epoch + 1)

    metrics_path = str(cfg.tpu.get("metrics_jsonl", "") or "")
    if metrics_path and not os.path.isabs(metrics_path):
        metrics_path = os.path.join(cfg.dataset.save_dir, "log", metrics_path)
    metrics_writer = MetricsWriter(metrics_path if rank0 else "")

    logging.info("Start training........")
    for epoch in range(start_epoch, cfg.train.max_epochs):
        if profile_dir and rank0 and epoch == start_epoch + 1 and profiler is None:
            # trace the 2nd epoch and its validation (the 1st carries the
            # kernels' builds and the pinned-memory allocations); every
            # thread, so the loader's producer shows its spans too
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            profiler = profile(activities=acts, experimental_config=_ExperimentalConfig(profile_all_threads=True))
            profiler.start()
            trace.enable()  # the program's spans over the kernels they launched
        logging.info(">>>>>> epoch %d <<<<<<", epoch)
        total_correct, total_count, total_loss, logged_steps = 0, 0, 0.0, 0
        log_every = max(int(cfg.tpu.get("log_every", 1)), 1)
        pending = []  # metrics read lazily so the device never waits on the host

        def host_batches():
            for b in train_loader:
                yield (b.appearance_feat, b.motion_feat, b.question, b.question_len, b.answer, b.valid)

        batches = prefetch_to_device(host_batches(), dev, size=prefetch, local=mesh is not None)
        for i, device_batch in enumerate(batches):
            pending.append(train_lib.train_step(state, device_batch, alpha=cfg.alpha, beta=cfg.beta))
            if stop_event is not None and stop_event.is_set():
                # mid-epoch preemption: save with epoch-1 so resume re-runs
                # this epoch from its start (epoch-level granularity)
                if autosave_on:
                    _autosave(epoch - 1, f"preempted at step {i + 1}")
                preempted = True
                break
            if (i + 1) % log_every == 0 or (i + 1) == steps_per_epoch:
                for m in pending:
                    total_loss += float(m["loss"])
                    total_correct += float(m["correct"])
                    total_count += int(m["count"])
                    logged_steps += 1
                last = pending[-1]
                pending = []
                progress = epoch + (i + 1) / steps_per_epoch
                batch_acc = float(last["correct"]) / max(int(last["count"]), 1)
                if not rank0:
                    continue
                train_ticker(progress, float(last["ce"]), total_loss / max(logged_steps, 1), batch_acc,
                             total_correct / max(total_count, 1), cfg.exp_name)
                metrics_writer.write(
                    "train",
                    epoch=epoch,
                    step=state.step,
                    ce=round(float(last["ce"]), 6),
                    avg_loss=round(total_loss / max(logged_steps, 1), 6),
                    batch_acc=round(batch_acc, 6),
                    avg_acc=round(total_correct / max(total_count, 1), 6),
                    # the lr of the last applied update, by the JAX
                    # train.py's formula over micro-steps (its lines 296-299)
                    lr=float(state.optimizer.lr(max(state.step // grad_accum - 1, 0))),
                )
        if rank0:
            sys.stdout.write("\n")
        if preempted:
            if profiler is not None:
                _write_profile(profiler, profile_dir, epoch)
            logging.warning("stopping on preemption signal (epoch %d); resume with train.restore: True", epoch)
            break
        logging.info("Epoch = %d   avg_loss = %.3f    avg_acc = %.3f", epoch,
                     total_loss / max(steps_per_epoch, 1), total_correct / max(total_count, 1))

        if cfg.val.flag and val_loader is not None:
            valid_acc, *cat_accs = validate_lib.validate(
                cfg, train_lib.pred_step, state, val_loader, write_preds=False, device=dev, prefetch=prefetch,
                mesh=mesh,
            )
            logging.info("~~~~~~ Valid Accuracy: %.4f ~~~~~~~", valid_acc)
            for nm, a in zip(cat_names, cat_accs):
                logging.info("  %s accuracy: %.4f", nm, a)
            metrics_writer.write(
                "val",
                epoch=epoch,
                acc=round(float(valid_acc), 6),
                categories={nm: round(float(a), 6) for nm, a in zip(cat_names, cat_accs)},
                best=bool(valid_acc > best_val),
            )
            if valid_acc > best_val:
                best_val = valid_acc
                best_cats = cat_accs
                save_checkpoint(ckpt_dir, epoch, state, model_kwargs_tosave(cfg))
                logging.info("saved best checkpoint (val acc %.4f)", best_val)
        if profiler is not None:
            _write_profile(profiler, profile_dir, epoch)
            profiler, profile_dir = None, ""  # one traced epoch

        if autosave_on:
            _autosave(epoch, "epoch end")

    if rank0 and not preempted and os.path.exists(autosave_dir):
        # clean completion: drop the autosave so `train.restore: True`
        # restores the BEST checkpoint (reference semantics), not the last
        shutil.rmtree(autosave_dir)
    if mesh is not None:
        dist.barrier()

    if best_cats is not None:
        logging.info("~~~~~~ Best Valid Accuracy: %.4f ~~~~~~~", best_val)
        for nm, a in zip(cat_names, best_cats):
            logging.info("  best %s accuracy: %.4f", nm, a)
    metrics_writer.close()
    return best_val, state


def main(argv=None):
    parser = argparse.ArgumentParser()
    # same four flags + defaults as reference train.py:370-375, and the device
    parser.add_argument("--cfg", dest="cfg_file", default="msvd_qa_DualVGR.yml", type=str)
    parser.add_argument("--alpha", dest="alpha", default=1, type=float)
    parser.add_argument("--beta", dest="beta", default=1e-8, type=float)
    parser.add_argument("--unit_layers", dest="unit_layers", default=1, type=int)
    parser.add_argument("--device", dest="device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)

    cfg = cfg_from_file(args.cfg_file)
    if cfg.dataset.name not in ("svqa", "msrvtt-qa", "msvd-qa"):
        raise ValueError(f"dataset.name must be svqa, msrvtt-qa or msvd-qa, got {cfg.dataset.name!r}")
    if not os.path.exists(cfg.dataset.data_dir):
        raise FileNotFoundError(f"dataset.data_dir {cfg.dataset.data_dir!r} does not exist")
    resolve_device(args.device)

    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    os.makedirs(cfg.dataset.save_dir, exist_ok=True)
    setup_logging(cfg.dataset.save_dir, cfg.model_type)

    cfg.alpha = args.alpha
    cfg.beta = args.beta
    cfg.unit_layers = args.unit_layers
    for k, v in cfg.items():
        logging.info("%s:%s", k, v)
    cfg = resolve_dataset_paths(cfg)

    np.random.seed(cfg.seed)

    # preemption-safe stop: the first SIGTERM/SIGINT asks for an autosave
    # and a stop at the next step; a second one falls through to the
    # default handler (hard kill)
    stop = threading.Event()
    prev_handlers = {}

    def _request_stop(signum, frame):
        logging.warning("received signal %d: checkpointing to autosave, then stopping (send again to force)",
                        signum)
        stop.set()
        for s, h in prev_handlers.items():
            signal.signal(s, h)

    if threading.current_thread() is threading.main_thread():
        for s in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[s] = signal.signal(s, _request_stop)
    try:
        return train(cfg, stop_event=stop, device=args.device)
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
