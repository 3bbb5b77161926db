"""Checkpoints: the train state saved with ``torch.save``, best-on-val policy.

The port's counterpart of the JAX package's ``utils/checkpoint.py``, with
its directory layout:

* ``{ckpt_dir}/model/model_kwargs.json``: the model's size arguments;
* ``{ckpt_dir}/model/meta.json``: ``epoch`` and ``step``, readable without
  a restore (the resume policy's choice between the best-val and the
  autosave checkpoint needs only these);
* ``{ckpt_dir}/model/state.pt``: the state, in the reference's schema
  (reference train.py:359-367) — ``epoch``, ``state_dict`` (the model's,
  in the reference's key names), ``optimizer`` (Adam's ``state_dict()``)
  and ``model_kwargs`` — so that the reference's validate.py and the JAX
  package's ``port_reference.convert_reference_checkpoint`` read a GAT
  model's file as a reference ``*_model.pt`` (a GCN model's file has the
  same schema, but neither the reference nor that converter builds GCN
  banks); beside them the port's own ``step``,
  ``updates``, ``mini_step``, ``acc_grads`` and ``generator`` (the dropout
  generator's ``get_state()``).

A state placed on a mesh (``parallel.tp.place_state``) is saved whole:
every rank takes part in gathering its shards and slices, rank 0 alone
writes, and the others wait for the file at a barrier; the file is the one
a single process writes. It is restored into an unplaced state, on rank 0
alone, and placed after (``place_state`` broadcasts it).

The file holds only tensors, numbers, strings, lists and dicts, so
``torch.load(..., weights_only=True)`` reads it. A restore is bit-exact on
every field. As in the JAX package, a resumed run replays the restored
epoch from its start with a freshly seeded loader.
"""

from __future__ import annotations

import json
import os

import torch
import torch.distributed as dist

from dualvgr_tpu_torch.train_lib import TrainState

_STATE_FILE = "state.pt"
_KWARGS_FILE = "model_kwargs.json"
_META_FILE = "meta.json"


def saved_epoch(ckpt_dir: str) -> int | None:
    """Epoch of the checkpoint under ``ckpt_dir``, or None if there is no
    checkpoint. A checkpoint without a readable meta.json reports -1 (valid
    but never preferred over one with a recorded epoch)."""
    model_dir = os.path.join(ckpt_dir, "model")
    if not os.path.exists(model_dir):
        return None
    try:
        with open(os.path.join(model_dir, _META_FILE)) as f:
            return int(json.load(f)["epoch"])
    except (OSError, ValueError, KeyError):
        return -1


def to_cpu(obj):
    """``obj`` with every tensor in it (through dicts, lists, tuples) detached on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_checkpoint(ckpt_dir: str, epoch: int, state: TrainState, model_kwargs: dict):
    """Write the train state + model_kwargs under {ckpt_dir}/model (a
    placed state: collective, written by rank 0)."""
    if state.placement is not None:
        from dualvgr_tpu_torch.parallel.tp import full_state_dicts

        model_sd, opt_sd, acc = full_state_dicts(state)
        if dist.get_rank() != 0:
            dist.barrier()
            return
    else:
        model_sd, opt_sd, acc = state.model.state_dict(), state.adam.state_dict(), state.acc_grads
    path = os.path.abspath(os.path.join(ckpt_dir, "model"))
    os.makedirs(path, exist_ok=True)
    payload = {
        "epoch": int(epoch),
        "state_dict": to_cpu(model_sd),
        "optimizer": to_cpu(opt_sd),
        "model_kwargs": dict(model_kwargs),
        "step": int(state.step),
        "updates": int(state.updates),
        "mini_step": int(state.mini_step),
        "acc_grads": to_cpu(acc),
        "generator": state.generator.get_state(),
    }
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    with open(os.path.join(path, _KWARGS_FILE), "w") as f:
        json.dump(model_kwargs, f, indent=2)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump({"epoch": int(epoch), "step": int(state.step)}, f)
    if state.placement is not None:
        dist.barrier()


def load_model_kwargs(ckpt_dir: str) -> dict:
    with open(os.path.abspath(os.path.join(ckpt_dir, "model", _KWARGS_FILE))) as f:
        return json.load(f)


def restore_checkpoint(ckpt_dir: str, state: TrainState) -> tuple[int, TrainState]:
    """Restore into ``state`` (its model, Adam, counts, accumulated
    gradients and generator, in place); returns (epoch, state). Raises if
    the saved accumulation window does not fit ``state`` (another
    ``grad_accum``), as a restore into another optimizer structure does in
    the JAX package."""
    path = os.path.abspath(os.path.join(ckpt_dir, "model", _STATE_FILE))
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if len(ck["acc_grads"]) != len(state.acc_grads):
        raise ValueError(
            f"checkpoint holds {len(ck['acc_grads'])} accumulated gradients, the state "
            f"{len(state.acc_grads)}: restore with the grad_accum it was saved with"
        )
    state.model.load_state_dict(ck["state_dict"], strict=True)
    # whether Adam is capturable is the state's own (``train_lib`` makes it so
    # where a CUDA graph takes the step), not the saving run's
    for saved, own in zip(ck["optimizer"]["param_groups"], state.adam.param_groups):
        saved["capturable"] = own["capturable"]
    state.adam.load_state_dict(ck["optimizer"])
    with torch.no_grad():
        for acc, saved in zip(state.acc_grads, ck["acc_grads"]):
            acc.copy_(saved)
    state.generator.set_state(ck["generator"])
    state.step, state.updates, state.mini_step = ck["step"], ck["updates"], ck["mini_step"]
    return int(ck["epoch"]), state


def load_reference_checkpoint(pt_path: str) -> tuple[dict, dict]:
    """A reference ``*_model.pt`` (or a port ``state.pt``) as (state_dict,
    model_kwargs): the state_dict in the reference's key names, a
    ``module.`` prefix (DataParallel) stripped, for
    ``DualVGR.load_state_dict``. The counterpart of the JAX package's
    ``port_reference.load_reference_checkpoint``, which must re-lay the
    weights out for flax; the port's modules take them as they are."""
    ck = torch.load(pt_path, map_location="cpu", weights_only=True)
    sd = ck["state_dict"] if isinstance(ck, dict) and "state_dict" in ck else ck
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    kwargs = ck.get("model_kwargs", {}) if isinstance(ck, dict) else {}
    return sd, dict(kwargs or {})
