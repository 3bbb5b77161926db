"""Multi-rank dry run: the train step and the eval step on N ranks against one process.

The counterpart of the JAX package's ``__graft_entry__.py::dryrun_multichip``.

    python -m dualvgr_tpu_torch.parallel.dryrun --nproc N [--tp K] [--device cuda|cpu]

spawns N ranks joined in a gloo group through a ``file://`` store, builds
a DualVGR at tiny widths from one seed on each, and runs one train step
(dropout on) and one eval step on a global batch of 8 rows, first data
parallel over N ranks, then (N/K) x K tensor parallel with ZeRO-1; each
loss must equal the one-process step's on the same global batch, and the
eval step's predictions the one-process ones. It prints one JSON line
and exits nonzero on a mismatch. It runs on the CUDA device unless
``--device cpu`` is given, and raises when CUDA is asked for and absent.
On CUDA every rank runs on ``cuda:0``: NCCL refuses two ranks on one
device, so the group is gloo over CUDA tensors there too.

The library part is what the tests and ``chip_smoke.py`` use:
``spawn(fn, nproc, ...)`` runs ``fn(rank, world, *args)`` on N ranks with
a timeout and returns each rank's result; ``run_steps(spec)`` builds,
places and steps a train state as a spec says, in one process (no group)
or on every rank of a group.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from dualvgr_tpu_torch.utils.device import resolve_device

# the tiny widths of the dry run (the JAX package's multichip test's)
TINY = dict(vision_dim=24, module_dim=16, word_dim=8, question_vocab_size=30, num_answers=10,
            num_of_nodes=4, graph_layers=1, unit_layers=1)
FRAMES, QLEN = 3, 5
# one process against N ranks, fp32, the same global batch: only the sum
# order of the collectives differs
RTOL = 2e-6


def tiny_batches(n: int = 1, batch: int = 8, seed: int = 7, pad: int = 0, dims=None):
    """``n`` global batches (app, motion, question, qlen, answers, valid) of
    numpy arrays at the tiny widths, one clip a graph node, the last ``pad``
    rows padded."""
    d = dict(TINY, **(dims or {}))
    clips = d["num_of_nodes"]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        app = rng.randn(batch, clips, FRAMES, d["vision_dim"]).astype(np.float32)
        mot = rng.randn(batch, clips, d["vision_dim"]).astype(np.float32)
        qlen = rng.randint(1, QLEN + 1, (batch,)).astype(np.int32)
        q = rng.randint(1, d["question_vocab_size"], (batch, QLEN)).astype(np.int32)
        for i in range(batch):
            q[i, qlen[i]:] = 0
        ans = rng.randint(0, d["num_answers"], (batch,)).astype(np.int32)
        valid = np.ones((batch,), np.float32)
        if pad:
            valid[-pad:] = 0.0
        out.append((app, mot, q, qlen, ans, valid))
    return out


def _module_grad_norms(model, params) -> dict:
    """The norm of each top-level module's gradient (whole parameters)."""
    ids = {id(p) for p in params}
    return {name: torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in mod.parameters() if id(p) in ids and p.grad is not None])).item()
        for name, mod in model.named_children() if any(id(p) in ids for p in mod.parameters())}


def run_steps(spec: dict) -> dict:
    """Build a DualVGR and its train state as ``spec`` says, place it on the
    group's mesh when a process group is up, run the train steps and the
    eval step, and report them (``eager``: each train step's
    ``train_lib.eager_reason``, None where a CUDA graph took it).

    ``spec``: ``dims`` (model kwargs), ``seed``, ``state_dict`` (optional),
    ``device`` (the card unless ``"cpu"``), ``tpu`` (``cfg.tpu`` keys, from
    which the model's kernels and dtype, the mesh and ZeRO-1 are taken as
    the CLIs take them:
    ``config.model_runtime_kwargs``, ``parallel.mesh_for``; the warnings
    logged on the way are in the result), ``dropout`` (False sets every
    rate to 0), ``lr``, ``grad_accum``, ``alpha``, ``beta``, ``batches``
    (global batches) or ``make_batches`` (a callable giving them, on the
    device), ``bucket_mb`` (the gradient all-reduce's buckets,
    ``place_state``'s), ``eval``, ``time`` (CUDA events a step, and a flat all-reduce
    of the gradient's size), ``full_state`` (the whole parameters in the
    result), ``init_state`` (the parameters before the steps, in one
    process).
    """
    import logging

    from dualvgr_tpu_torch.config import default_config, model_runtime_kwargs
    from dualvgr_tpu_torch.models.dualvgr import build_model
    from dualvgr_tpu_torch.ops import launch_counts
    from dualvgr_tpu_torch.ops.dropout import Dropout
    from dualvgr_tpu_torch.parallel.comm import all_gather_cat, all_reduce_
    from dualvgr_tpu_torch.parallel.mesh import mesh_axis, shard_batch
    from dualvgr_tpu_torch.parallel.tp import (
        BUCKET_MB, full_state_dicts, mesh_for, place_state, state_bytes, tp_sharded_leaf_count,
    )
    from dualvgr_tpu_torch.train_lib import create_train_state, eager_reason, make_optimizer, pred_step, train_step

    dev = spec.get("device", "cuda")
    cfg = default_config()
    cfg.tpu.update(spec.get("tpu", {}))
    axis = cfg.tpu.mesh_axis
    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger().addHandler(handler)
    try:
        runtime = model_runtime_kwargs(cfg, dev)
    finally:
        logging.getLogger().removeHandler(handler)
    model = build_model(device=dev, seed=spec.get("seed", 0), **runtime, **spec.get("dims", TINY))
    if spec.get("state_dict") is not None:
        model.load_state_dict(spec["state_dict"], strict=True)
    if not spec.get("dropout", True):
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    state = create_train_state(model, make_optimizer(spec.get("lr", 1e-3), 10, grad_accum=spec.get("grad_accum", 1)),
                               seed=spec.get("gen_seed", 0))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()} if spec.get("init_state") else None
    mesh = mesh_for(cfg, dev)
    place_state(state, mesh, zero_opt=bool(cfg.tpu.zero_opt), bucket_mb=spec.get("bucket_mb", BUCKET_MB))
    pl = state.placement
    batches = spec["make_batches"]() if "make_batches" in spec else spec["batches"]
    timed = spec.get("time", False) and torch.device(dev).type == "cuda"
    res = {"losses": [], "metrics": [], "grad_norms": [], "step_ms": [], "warnings": warnings,
           "use_kernels": model.use_kernels, "eager": []}
    n0 = launch_counts()
    for b in batches:
        local = shard_batch(b, mesh, axis) if mesh is not None else b
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        res["eager"].append(eager_reason(state))
        m = train_step(state, local, alpha=spec.get("alpha", 1.0), beta=spec.get("beta", 1e-8))
        if timed:
            ev[1].record()
            ev[1].synchronize()
            res["step_ms"].append(ev[0].elapsed_time(ev[1]))
        res["losses"].append(m["loss"].item())
        res["metrics"].append({k: v.item() for k, v in m.items()})
        params = [p.param for p in pl.params] if pl is not None else list(model.parameters())
        if pl is None or not pl.tp:
            res["grad_norms"].append(_module_grad_norms(model, params))
    res["launches_train"] = tuple(a - b for a, b in zip(launch_counts(), n0))
    bn = model.output_unit.classifier[3]
    res["bn_running"] = (bn.running_mean.detach().cpu().numpy(), bn.running_var.detach().cpu().numpy())
    if spec.get("eval", False):
        n0 = launch_counts()
        app, mot, q, qlen = batches[0][:4]
        local = shard_batch((app, mot, q, qlen), mesh, axis) if mesh is not None else (app, mot, q, qlen)
        preds = pred_step(state, local)
        if pl is not None:
            preds = all_gather_cat(preds, pl.data, 0)
        res["preds"] = preds.cpu().numpy()
        res["launches_eval"] = tuple(a - b for a, b in zip(launch_counts(), n0))
    if pl is not None:
        sd, _, _ = full_state_dicts(state)
        res["tp_sharded_leaf_count"] = tp_sharded_leaf_count(state, mesh)
    else:
        sd = model.state_dict()
    res["state_bytes"] = state_bytes(state)
    res["checksum"] = float(sum(v.double().abs().sum().item() for k, v in sd.items()
                                if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))))
    if spec.get("full_state", False):
        res["state_dict"] = {k: v.detach().cpu() for k, v in sd.items()}
    if init is not None:
        res["state_dict_init"] = init
    if timed and pl is not None:
        flat = torch.zeros(sum(p.param.numel() for p in pl.params), device=dev)
        all_reduce_(flat, pl.data)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(3):
            all_reduce_(flat, pl.data)
        ev[1].record()
        ev[1].synchronize()
        res["allreduce_ms"] = ev[0].elapsed_time(ev[1]) / 3
        res["allreduce_mb"] = flat.numel() * 4 / 1e6
    if mesh is not None:
        res["rank"], res["data_rank"] = dist.get_rank(), mesh_axis(mesh, axis).rank
        res["buckets"] = len(pl.buckets.buckets) if pl.buckets is not None else 0
    return res


def _rank_main(rank, world, init_file, out_file, device, fn, args):
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(0)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank)
        try:
            out = {"result": fn(rank, world, *args)}
        finally:
            dist.destroy_process_group()
    except Exception:  # handed to the parent, which raises it
        out = {"error": traceback.format_exc()}
    torch.save(out, out_file)


def spawn(fn, nproc: int, args=(), *, device: str = "cuda", timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``nproc`` spawned ranks in a gloo
    group joined through a ``file://`` store (every rank on ``cuda:0`` with
    a CUDA ``device``, one CPU thread each with ``device="cpu"``; CUDA
    asked for on a machine without it raises, ``resolve_device``). Returns
    each rank's result in rank order. Raises the first rank's error, or
    TimeoutError (after killing every rank) when ``timeout`` seconds pass."""
    import torch.multiprocessing as mp

    device = resolve_device(device)

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dualvgr_dryrun_") as tmp:
        init_file = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(nproc)]
        procs = [ctx.Process(target=_rank_main, args=(r, nproc, init_file, outs[r], device, fn, tuple(args)),
                             daemon=True) for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
            if any(p.is_alive() for p in procs):
                raise TimeoutError(f"{nproc} ranks did not finish within {timeout} s")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, path in enumerate(outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} and no result")
            got = torch.load(path, weights_only=False)
            if "error" in got:
                raise RuntimeError(f"rank {r} failed:\n{got['error']}")
            results.append(got["result"])
        return results


def steps_on_rank(rank, world, specs):
    """``run_steps`` of each spec in turn on one rank of a spawned group
    (each on a mesh of its own); a list of their results."""
    del rank, world
    return [run_steps(spec) for spec in specs]


def _recording_loaders(module, seen):
    """``module.make_loader`` wrapped to append each loader's
    (host_index, host_count) to ``seen``; returns the original."""
    make = module.make_loader

    def recording(*args, **kw):
        loader = make(*args, **kw)
        seen.append((loader.host_index, loader.host_count))
        return loader

    module.make_loader = recording
    return make


def train_cli_on_rank(rank, world, cfg, device, feature_stores=None):
    """The train CLI (``dualvgr_tpu_torch.train.train``) on one rank of a
    spawned group, on ``device`` (``spawn``'s): returns (best val accuracy,
    the final state gathered whole (rank 0; None elsewhere), the step
    count, each loader's (host_index, host_count))."""
    from dualvgr_tpu_torch import train as ttrain
    from dualvgr_tpu_torch.parallel.tp import full_state_dicts

    seen = []
    make = _recording_loaders(ttrain, seen)
    try:
        best, state = ttrain.train(cfg, device=device, feature_stores=feature_stores)
    finally:
        ttrain.make_loader = make
    sd = full_state_dicts(state)[0]
    return best, ({k: v.cpu() for k, v in sd.items()} if rank == 0 else None), state.step, seen


def validate_cli_on_rank(rank, world, cfg, unit_layers, device):
    """The validate CLI (``dualvgr_tpu_torch.validate.run``) on one rank of
    a spawned group: returns (its accuracies, the test loader's
    (host_index, host_count))."""
    del rank, world
    from dualvgr_tpu_torch import validate as tvalidate

    seen = []
    make = _recording_loaders(tvalidate, seen)
    try:
        out = tvalidate.run(cfg, unit_layers, device=device)
    finally:
        tvalidate.make_loader = make
    return out, seen


def _close(a, b, rtol=RTOL) -> bool:
    return bool(np.allclose(a, b, rtol=rtol, atol=0.0))


def dryrun(nproc: int, tp: int = 2, device: str = "cuda", timeout: float = 120.0) -> dict:
    """One train step (dropout on) and one eval step at the tiny widths, DP
    over ``nproc`` ranks and then (nproc/tp) x tp TP + ZeRO-1, against one
    process on the same global batch. Returns the report; ``ok`` is False
    on a mismatch."""
    if nproc % tp:
        raise ValueError(f"--tp {tp} does not divide --nproc {nproc}")
    batch = max(8, nproc)
    base = dict(device=device, batches=tiny_batches(1, batch=batch, pad=1), eval=True)
    tp_zero = dict(base, tpu=dict(tensor_parallel=tp, zero_opt=True))
    one = run_steps(base)
    report = {"nproc": nproc, "tp": tp, "device": device, "loss_one_process": one["losses"][0]}
    ok = True
    t0 = time.perf_counter()
    runs = spawn(steps_on_rank, nproc, ([base, tp_zero],), device=device, timeout=timeout)
    report["seconds"] = round(time.perf_counter() - t0, 2)
    for i, tag in enumerate(("dp", "tp_zero")):
        ranks = [r[i] for r in runs]
        losses = [r["losses"][0] for r in ranks]
        same_preds = all(np.array_equal(r["preds"], one["preds"]) for r in ranks)
        good = all(_close(x, one["losses"][0]) for x in losses) and same_preds
        ok = ok and good
        report[tag] = {"losses": losses, "preds_equal": same_preds, "ok": good,
                       "tp_sharded_leaf_count": ranks[0].get("tp_sharded_leaf_count", 0)}
    report["ok"] = ok
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--tp", type=int, default=2)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--timeout", type=float, default=120.0)
    args = parser.parse_args(argv)
    resolve_device(args.device)  # raises when CUDA is asked for and absent
    report = dryrun(args.nproc, args.tp, args.device, args.timeout)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
