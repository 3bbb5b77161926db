"""Ahead-of-time serving export: model + weights -> one ``.dvgr`` artifact.

The port's counterpart of the JAX package's ``dualvgr_tpu/export.py``: the
serving program (eval forward, softmax, top-k over fixed shapes, weights
embedded) is exported once with ``torch.export``, and a serving host loads
the file and runs it without the model code's Python, the checkpoint or
the config. The kernels on the path (kernel 1, the BiLSTM recurrence;
kernel 2, the graph cycle; the appearance projection, kernel 7 in fp32 or
kernel 6 with its tanh pass under ``compute_dtype: bfloat16``) are torch
custom ops
(``torch.ops.dualvgr_torch.*``, registered by ``ops/lstm_kernel.py``,
``ops/gat_kernel.py`` and ``ops/proj_kernel.py``), so the exported graph
holds one node for each launch, and a loaded program on the card launches
the same kernels, counted by the same ``.launches`` counters. Export traces
with the kernel routing (``use_kernels``) of the model it is given; the
CLI builds it with ``tpu.use_pallas`` as for the card on every platform,
so a ``cpu`` program holds the same ops and runs their plain versions.

Artifact format (single file): an 8-byte magic (``DVGRTXP1``; the JAX
package's loader refuses it, and this loader refuses the JAX package's
``DVGRXPT1`` files), a 4-byte little-endian header length, the JSON
header and the payload. The header holds the JAX package's keys
(``max_batch``, ``app_shape``, ``mot_shape``, ``max_q_len``, ``top_k``,
``platforms``) and ``payload_bytes``: the payload is one
``torch.export.save`` blob for each platform in ``platforms`` (``cpu``,
``cuda``), in that order, since a traced graph holds its device in its
constants. ``load_artifact`` returns ``(predict_fn, meta)`` with the
``BatchingEngine`` contract: ``predict_fn(app, mot, q, qlen) -> (ids,
scores)``, numpy (max_batch, top_k) each.

CLI (the checkpoint of ``python -m dualvgr_tpu_torch.train``)::

    python -m dualvgr_tpu_torch.export --cfg configs/msvd_qa_DualVGR.yml \\
        --out msvd.dvgr [--unit_layers 1] [--max-batch 32] [--max-q-len 32] \\
        [--topk 5] [--platforms cuda|cpu|cpu,cuda]

then ``python -m dualvgr_tpu_torch.serve --cfg ... --artifact msvd.dvgr``.
``--platforms`` defaults to ``cuda``, which needs the card; the program
takes the config's ``tpu.compute_dtype``, so there are fp32 and bf16
artifacts.
"""

from __future__ import annotations

import collections
import io
import json
import os
import struct

import torch

# the kernels' custom ops must be registered before a program that holds
# them is loaded
from dualvgr_tpu_torch.ops import gat_kernel, lstm_kernel, proj_kernel  # noqa: F401
from dualvgr_tpu_torch.serving import ServingProgram, build_predict_fn, model_on
from dualvgr_tpu_torch.utils.device import resolve_device

__all__ = ["build_predict_fn", "export_serving", "save_artifact", "read_artifact", "load_artifact", "graph_ops",
           "model_from_checkpoint"]

_MAGIC = b"DVGRTXP1"
PLATFORMS = ("cpu", "cuda")


def export_serving(model, *, max_batch: int, app_shape: tuple, mot_shape: tuple, max_q_len: int,
                   top_k: int, platforms: tuple = ("cuda",)) -> tuple[bytes, dict]:
    """Export the fixed-shape serving program for each of ``platforms``;
    returns (payload, meta). The inputs are app (max_batch, *app_shape)
    and mot (max_batch, *mot_shape) float32, q (max_batch, max_q_len) and
    qlen (max_batch,) int32. ``cuda`` needs the card. The model's mode is
    restored afterwards."""
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms must be distinct names from {PLATFORMS}, got {platforms}")
    was_training = model.training
    blobs = []
    try:
        for platform in platforms:
            dev = resolve_device(platform)
            program = ServingProgram(model_on(model, dev), top_k).eval()
            args = (
                torch.zeros((max_batch, *app_shape), dtype=torch.float32, device=dev),
                torch.zeros((max_batch, *mot_shape), dtype=torch.float32, device=dev),
                torch.zeros((max_batch, max_q_len), dtype=torch.int32, device=dev),
                torch.ones((max_batch,), dtype=torch.int32, device=dev),
            )
            with torch.no_grad():
                exported = torch.export.export(program, args)
            exported.example_inputs = None  # the zero batch would ride along in the file (71 MB at the flagship)
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            blobs.append(buf.getvalue())
    finally:
        model.train(was_training)
    meta = {
        "max_batch": int(max_batch),
        "app_shape": [int(d) for d in app_shape],
        "mot_shape": [int(d) for d in mot_shape],
        "max_q_len": int(max_q_len),
        "top_k": int(top_k),
        "platforms": list(platforms),
        "payload_bytes": [len(b) for b in blobs],
    }
    return b"".join(blobs), meta


def save_artifact(path: str, payload: bytes, meta: dict) -> None:
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload)


def read_artifact(path: str) -> tuple[dict, bytes]:
    """(meta, payload) of an artifact; raises ValueError on any other file."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a dualvgr export artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode())
        payload = f.read()
    if sum(meta["payload_bytes"]) != len(payload):
        raise ValueError(f"{path}: payload holds {len(payload)} bytes, the header {meta['payload_bytes']}")
    return meta, payload


def graph_ops(program) -> collections.Counter:
    """How often each op is called in an exported program's graph, by name
    (``dualvgr_torch.gat_cycle.default``, ``aten.leaky_relu.default``, ...)."""
    return collections.Counter(str(n.target) for n in program.graph.nodes if n.op == "call_function")


def load_artifact(path: str, device="cuda"):
    """-> (predict_fn, meta): the artifact's program for ``device`` (the card
    unless ``device='cpu'``), as ``predict_fn(app, mot, q, qlen) -> (ids,
    scores)`` numpy arrays; ``predict_fn.program`` is the loaded
    ``ExportedProgram``. Raises ValueError if it was not exported for
    the device's platform."""
    dev = resolve_device(device)
    meta, payload = read_artifact(path)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"{path}: exported for {meta['platforms']}, not {dev.type!r}: re-export with "
                         f"--platforms {dev.type}")
    i = meta["platforms"].index(dev.type)
    start = sum(meta["payload_bytes"][:i])
    program = torch.export.load(io.BytesIO(payload[start : start + meta["payload_bytes"][i]]))
    if dev.type == "cuda" and any(t.device != dev for t in program.state_dict.values()):
        from torch.export.passes import move_to_device_pass  # a program exported on another card

        program = move_to_device_pass(program, dev)
    module = program.module()

    @torch.no_grad()
    def predict(app, mot, q, qlen):
        app, mot = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (app, mot))
        q, qlen = (torch.as_tensor(a, dtype=torch.int32, device=dev) for a in (q, qlen))
        ids, scores = module(app, mot, q, qlen)
        return ids.cpu().numpy(), scores.cpu().numpy()

    predict.program = program  # for a look at its graph (``graph_ops``)
    return predict, meta


def model_from_checkpoint(cfg, unit_layers: int, *, device="cuda"):
    """(model in eval mode, vocab) from the checkpoint of ``cfg`` (its
    ``dataset.save_dir`` already joined with ``exp_name``): the saved
    model_kwargs, the vocab's sizes, ``unit_layers`` and the config's
    ``tpu`` knobs resolved for ``device``, the weights from
    ``{save_dir}/ckpt/model/state.pt`` (no optimizer state is used)."""
    from dualvgr_tpu_torch.config import model_runtime_kwargs, resolve_dataset_paths
    from dualvgr_tpu_torch.data.vocab import load_vocab
    from dualvgr_tpu_torch.models.dualvgr import build_model
    from dualvgr_tpu_torch.utils.checkpoint import load_model_kwargs, load_reference_checkpoint

    dev = resolve_device(device)
    ckpt_dir = os.path.join(cfg.dataset.save_dir, "ckpt")
    state_pt = os.path.join(ckpt_dir, "model", "state.pt")
    if not os.path.exists(state_pt):
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    vocab = load_vocab(resolve_dataset_paths(cfg).dataset.vocab_json)
    kw = load_model_kwargs(ckpt_dir)
    runtime = model_runtime_kwargs(cfg, dev)
    model = build_model(
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
    state_dict, _ = load_reference_checkpoint(state_pt)
    model.load_state_dict(state_dict, strict=True)
    return model.eval(), vocab


def feature_shapes(cfg) -> tuple[tuple, tuple]:
    """(appearance, motion) shapes of one video, from the config's HDF5 files."""
    from dualvgr_tpu_torch.config import resolve_dataset_paths
    from dualvgr_tpu_torch.data.features import FeatureStore

    paths = resolve_dataset_paths(cfg).dataset
    shapes = []
    for path, name in ((paths.appearance_feat, "resnet_features"), (paths.motion_feat, "resnext_features")):
        store = FeatureStore(path, name, cache_gb=0.0)
        shapes.append(tuple(store.shape[1:]))
        store.close()
    return shapes[0], shapes[1]


def main(argv=None):
    import argparse
    import logging

    from dualvgr_tpu_torch.config import cfg_from_file, resolved_use_kernels
    from dualvgr_tpu_torch.utils.logging import setup_logging

    p = argparse.ArgumentParser(description="Export the serving program of a checkpoint to a .dvgr artifact")
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--out", required=True, help="artifact path (.dvgr)")
    p.add_argument("--unit_layers", type=int, default=1)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-q-len", type=int, default=32)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--platforms", default="cuda",
                   help="comma-separated platforms of the artifact: cuda (the default; needs the card), cpu, "
                        "or cpu,cuda")
    args = p.parse_args(argv)
    platforms = tuple(args.platforms.split(","))

    cfg = cfg_from_file(args.cfg_file)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    setup_logging()
    model, vocab = model_from_checkpoint(cfg, args.unit_layers, device=platforms[0])
    model.use_kernels = resolved_use_kernels(cfg, "cuda")  # the card's routing on every platform
    app_shape, mot_shape = feature_shapes(cfg)
    payload, meta = export_serving(
        model, max_batch=args.max_batch, app_shape=app_shape, mot_shape=mot_shape, max_q_len=args.max_q_len,
        top_k=min(args.topk, len(vocab["answer_token_to_idx"])), platforms=platforms,
    )
    save_artifact(args.out, payload, meta)
    logging.info("wrote %s (%.1f MB, platforms=%s, batch=%d, topk=%d, compute_dtype=%s)", args.out,
                 len(payload) / 1e6, meta["platforms"], meta["max_batch"], meta["top_k"], model.compute_dtype)
    return meta


if __name__ == "__main__":
    main()
