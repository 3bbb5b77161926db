"""Training cells: the program's train loop, as its train CLI runs it.

``VideoQADataLoader`` (shuffled, pinned, the native gather) feeds
``prefetch_to_device``, a new one each epoch, which feeds
``train_lib.train_step``; each step's metrics are read back as the CLI
reads them at its default ``log_every`` of 1. Set-up builds the one train
state the window drives and takes its first steps through that same loop:
the reference then replays them (losses, the first clipped gradient, the
parameters' change after them).

``train_qa_per_s``: the questions of every step that completed in the
window over the window's seconds.
"""

from __future__ import annotations

import collections
import re
import time

import numpy as np
import torch

from perfbench.lib import data
from perfbench.lib.common import sub_seed
from perfbench.lib.harness import build_program_model, checks_of, free, leaf_gaps, memory_peak
from perfbench.lib.weights import make_weights, parameters
from perfbench.reference import dualvgr as reference

ADAM_BETA1 = 0.9


def _stream(loader, device, prefetch):
    """(host batch, device batch) pairs, epoch after epoch, as the train
    CLI's loop makes them."""
    from dualvgr_tpu_torch.parallel.mesh import prefetch_to_device

    while True:
        pending = collections.deque()

        def host():
            for b in loader:
                pending.append(b)
                yield (b.appearance_feat, b.motion_feat, b.question, b.question_len, b.answer, b.valid)

        for device_batch in prefetch_to_device(host(), device, size=prefetch):
            yield pending.popleft(), device_batch


def _norms(tensors: dict) -> dict:
    keys = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double()) for k in keys]).tolist()
    return dict(zip(keys, norms))


def run(ctx):
    from dualvgr_tpu_torch import train_lib
    from dualvgr_tpu_torch.data.features import FeatureStore
    from dualvgr_tpu_torch.data.loader import VideoQADataLoader

    cfg, wl, dev, m = ctx.config, ctx.workload, ctx.device, ctx.model
    split = data.make_split(cfg, "train", ctx.seed, dev, videos=wl.get("videos"), questions=wl.get("questions"))
    question_pt, vocab_json = data.write_files(split, ctx.tmpdir, cfg["name"] + "_train")
    ctx.stage("data")
    weights = make_weights(reference.param_spec(**m), ctx.seed, dev)
    model = build_program_model(ctx, weights)
    ctx.stage("weights and model")
    ids = np.arange(split.app.shape[0])
    loader = VideoQADataLoader(
        question_pt=question_pt, vocab_json=vocab_json,
        appearance_feat=FeatureStore.from_array(ids, split.app, "resnet_features"),
        motion_feat=FeatureStore.from_array(ids, split.mot, "resnext_features"),
        batch_size=wl["batch_size"], shuffle=True, num_workers=cfg["train"]["num_workers"],
        seed=sub_seed(ctx.seed, "loader") % (1 << 32), prefetch=wl["prefetch"],
        pin_memory=dev.type == "cuda")
    tr = cfg["train"]
    optimizer = train_lib.make_optimizer(tr["lr"], len(loader), max_grad_norm=tr["max_grad_norm"])
    dropout_seed = sub_seed(ctx.seed, "dropout")
    state = train_lib.create_train_state(model, optimizer, seed=dropout_seed)
    names = [k for k, _ in model.named_parameters()]
    step_fn = ctx.hook("train_step", train_lib.train_step)
    kw = dict(alpha=tr["alpha"], beta=tr["beta"])
    batches = _stream(loader, dev, wl["prefetch"])
    ctx.stage("loader and train state")
    rec = ctx.rec

    def one_step():
        with rec.span("loader.wait"):
            host, device_batch = next(batches)
        rec.step({"rows": int(host.valid.shape[0]), "valid": int(host.valid.sum()),
                  "qlen_sum": int(host.question_len.sum()), "q_pad": int(host.question.shape[1])})
        with rec.span("train_step"), rec.timed("train_step"):
            metrics = step_fn(state, device_batch, **kw)
        with rec.span("metrics.read"):  # as the train CLI reads them each step
            loss, _, count = float(metrics["loss"]), float(metrics["correct"]), int(metrics["count"])
            float(metrics["ce"])
        return host, loss, count

    try:
        # the checked steps: the window's own call and feed, from the seed
        checked = []
        for i in range(wl["checked_steps"]):
            host, loss, _ = one_step()
            checked.append((host.question_idx.copy(), host.valid.copy(), loss))
            if i == 0:
                moments = {n: state.adam.state.get(p, {}).get("exp_avg") for n, p in
                           zip(names, model.parameters())}
                grad1 = _norms({n: (v if v is not None else torch.zeros(1, device=dev)) / (1 - ADAM_BETA1)
                                for n, v in moments.items()})
        change = _norms({n: p.detach() - weights[n] for n, p in model.named_parameters()})
        ctx.stage("checked steps")
        for _ in range(wl["warmup_steps"]):
            one_step()
        ctx.stage("warm-up")

        questions = 0
        if not ctx.readings_only:
            t0 = rec.begin_window()
            while time.perf_counter() - t0 < ctx.seconds:
                rec.boundary()
                questions += one_step()[2]
            t1 = time.perf_counter()
            rec.finish()
        else:
            t0 = t1 = time.perf_counter()
        peak = memory_peak(dev)
    finally:
        batches.close()
        loader.close()
    del state, model, batches, loader
    free(dev)

    checks = checks_of(ctx, _compare(ctx, split, weights, checked, grad1, change, dropout_seed))
    return {
        "window": (t0, t1), "attempted": questions, "failed": 0, "memory_peak_bytes": peak,
        "e2e": {"train_qa_per_s": questions / (t1 - t0) if t1 > t0 else 0.0},
        "checks": checks,
    }


def _compare(ctx, split, weights, checked, grad1, change, dropout_seed) -> dict:
    """The readings: the reference replays the checked steps from the same
    weights, batches and dropout seed."""
    m, tr, dev = ctx.model, ctx.config["train"], ctx.device
    ids = np.concatenate([q[v > 0] for q, v, _ in checked])
    distinct = len(np.unique(ids)) == len(ids)
    params = {k: v.clone() for k, v in parameters(weights).items()}
    buffers = {k: v.clone() for k, v in weights.items() if k not in params}
    adam = reference.Adam(params, tr["lr"], tr["max_grad_norm"])
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    losses = []
    for i, (qids, valid, _) in enumerate(checked):
        batch = (*data.batch_of(split, qids, dev), torch.as_tensor(valid, device=dev))
        loss, clipped = reference.train_step(params, buffers, adam, batch, generator=gen, alpha=tr["alpha"],
                                             beta=tr["beta"], unit_layers=m["unit_layers"],
                                             graph_layers=m["graph_layers"])
        losses.append(loss)
        if i == 0:
            grad1_ref = _norms(clipped)
    change_ref = _norms({k: params[k] - weights[k] for k in params})
    # leaves whose gradient is nought to rounding in the reference move under
    # Adam by round-off alone: left out of the change by their gradient
    median = float(np.median(list(grad1_ref.values())))
    moving = [k for k in params if grad1_ref[k] >= 1e-3 * median]
    leaf = {"grad1": leaf_gaps(grad1, grad1_ref), "change": leaf_gaps(change, change_ref, moving)}
    module = {"grad1": leaf_gaps(*(module_norms(n) for n in (grad1, grad1_ref))),
              "change": leaf_gaps(*(module_norms(n, moving) for n in (change, change_ref)))}
    worst = lambda gaps: ", ".join(f"{k} {gaps[k]:.3e}" for k in sorted(gaps, key=gaps.get, reverse=True)[:3])
    ctx.say(f"checked steps: losses {[c[2] for c in checked]} reference {losses}; the reference's gradient "
            f"norms before the clip at {tr['max_grad_norm']}: {adam.norms}; {len(params) - len(moving)} of "
            f"{len(params)} leaves without a gradient left out of the change; widest leaf gaps: first gradient "
            f"{worst(leaf['grad1'])}; change {worst(leaf['change'])}; widest module gaps: first gradient "
            f"{worst(module['grad1'])}; change {worst(module['change'])}")
    return {
        "loss_gap": max(abs(p[2] - r) / abs(r) for p, r in zip(checked, losses)),
        "grad1_gap": max(module["grad1"].values()), "change_gap": max(module["change"].values()),
        "grad1_leaf_gap": max(leaf["grad1"].values()), "change_leaf_gap": max(leaf["change"].values()),
        "change_median_gap": float(np.median(list(leaf["change"].values()))),
        "rows_repeated": 0.0 if distinct else 1.0,
    }


def module_norms(norms: dict, keys=None) -> dict:
    """The norm of each module's leaves together: the leaves of the module
    that owns them, a GAT bank's heads as one module."""
    out = {}
    for k in (norms if keys is None else keys):
        owner = re.sub(r"\.attention_\d+\.(W|a)$", "", k.rsplit(".", 1)[0])
        out[owner] = out.get(owner, 0.0) + norms[k] ** 2
    return {k: v ** 0.5 for k, v in out.items()}
