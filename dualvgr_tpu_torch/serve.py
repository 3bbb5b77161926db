"""Serving front: batched video-QA answers over HTTP, on the card.

The port's copy of the JAX package's root ``serve.py``: loads the best
checkpoint of ``python -m dualvgr_tpu_torch.train`` (weights and model
kwargs only) and the clip features, then serves

    POST /answer   {"video_id": "<id>", "question": "what is ...?"}
        -> {"answer": "...", "topk": [{"answer": ..., "score": ...}, ...]}
    GET  /healthz  -> {"ok": true}
    GET  /stats    -> batching and latency counters

with 400 for a bad body, 404 for an unknown video or path and 500 for a
failed answer. Every request funnels through one fixed-shape program via
``BatchingEngine`` (``--replicas N``: one engine per card,
``ReplicatedEngine``).

    python -m dualvgr_tpu_torch.serve --cfg configs/msvd_qa_DualVGR.yml \\
        [--port 8000] [--max-batch 32] [--max-wait-ms 2] [--topk 5] \\
        [--unit_layers 1] [--replicas 1] [--artifact model.dvgr] [--device cuda|cpu]

``--artifact`` serves a program exported by ``python -m
dualvgr_tpu_torch.export`` instead of the checkpoint; its header gives the
batch, question length and top-k. It runs on the card unless ``--device
cpu`` is given; there is no fallback. Questions are tokenized by
``dualvgr_tpu_torch.data.questions`` (no nltk). The library form,
``build_engine(..., feature_stores=(app, motion))``, takes in-memory
feature stores in place of the HDF5 files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dualvgr_tpu_torch.config import cfg_from_file, resolve_dataset_paths
from dualvgr_tpu_torch.data.features import FeatureStore
from dualvgr_tpu_torch.data.questions import encode_tokens, tokenize_question
from dualvgr_tpu_torch.data.vocab import load_vocab
from dualvgr_tpu_torch.export import load_artifact, model_from_checkpoint
from dualvgr_tpu_torch.serving import BatchingEngine, ReplicatedEngine, build_predict_fn, per_device_predict_fns
from dualvgr_tpu_torch.utils.device import resolve_device
from dualvgr_tpu_torch.utils.logging import setup_logging


def _assemble(cfg, predict, max_batch: int, max_wait_ms: float, max_q_len: int, *, device, devices=None,
              feature_stores=None):
    """Stores + vocab + engine + answer closure around a predict fn (or a
    list of per-replica predict fns on ``devices`` -> ReplicatedEngine).
    Returns (engine, answer_fn, (app_store, motion_store))."""
    cfg = resolve_dataset_paths(cfg)
    vocab = load_vocab(cfg.dataset.vocab_json)
    if feature_stores is None:
        feature_stores = (
            FeatureStore(cfg.dataset.appearance_feat, "resnet_features", cache_gb=cfg.tpu.feature_cache_gb),
            FeatureStore(cfg.dataset.motion_feat, "resnext_features", cache_gb=cfg.tpu.feature_cache_gb),
        )
    app_store, mot_store = feature_stores
    kwargs = dict(max_batch=max_batch, max_wait_ms=max_wait_ms, max_q_len=max_q_len,
                  feature_shapes=(tuple(app_store.shape[1:]), tuple(mot_store.shape[1:])))
    if isinstance(predict, (list, tuple)):
        engine = ReplicatedEngine(list(predict), devices=devices, **kwargs)
    else:
        engine = BatchingEngine(predict, device=device, **kwargs)
    ans_vocab = vocab["answer_idx_to_token"]
    q_vocab = vocab["question_token_to_idx"]

    def answer(video_id: str, question: str) -> dict:
        try:
            app, mot = app_store.row(video_id), mot_store.row(video_id)
        except (KeyError, ValueError):
            raise KeyError(f"unknown video_id {video_id!r}") from None
        tokens = tokenize_question(question if question.endswith("?") else question + "?")
        ids = np.asarray(encode_tokens(tokens, q_vocab), np.int32)[:max_q_len]
        top_i, top_p = engine.submit(app.float().numpy(), mot.float().numpy(), ids)
        return {
            "answer": ans_vocab[int(top_i[0])],
            "topk": [{"answer": ans_vocab[int(i)], "score": round(float(p), 6)} for i, p in zip(top_i, top_p)],
        }

    return engine, answer, feature_stores


def _replicate(replicas: int, device: torch.device, *, model=None, topk=None, artifact=None):
    """(predict fns, devices) of ``replicas`` > 1 replicas on the first
    cards, from a model or an artifact; raises if the machine has fewer
    cards or the device is the CPU."""
    if device.type != "cuda":
        raise ValueError(f"--replicas {replicas} places replicas on CUDA devices, not {device}")
    count = torch.cuda.device_count()
    if replicas > count:
        raise ValueError(f"--replicas {replicas} > {count} CUDA devices")
    devices = [torch.device("cuda", i) for i in range(replicas)]
    source = artifact if artifact is not None else model
    return per_device_predict_fns(source, topk, devices=devices), devices


def build_engine_from_artifact(cfg, artifact: str, max_wait_ms: float, replicas: int = 1, *, device="cuda",
                               feature_stores=None):
    """The serving program from a ``.dvgr`` export (no checkpoint, no model
    code); batch, question length and top-k from the artifact's header.
    Returns (engine, answer_fn, stores)."""
    dev = resolve_device(device)
    predict, meta = load_artifact(artifact, device=dev)
    devices = None
    if replicas > 1:
        predict, devices = _replicate(replicas, dev, artifact=artifact)
    engine, answer, stores = _assemble(cfg, predict, meta["max_batch"], max_wait_ms, meta["max_q_len"],
                                       device=dev, devices=devices, feature_stores=feature_stores)
    shapes = (list(stores[0].shape[1:]), list(stores[1].shape[1:]))
    if shapes != (meta["app_shape"], meta["mot_shape"]):
        engine.close()
        raise ValueError(f"{artifact} takes features {meta['app_shape']} and {meta['mot_shape']}, the stores "
                         f"hold {shapes[0]} and {shapes[1]}")
    return engine, answer, stores


def build_engine(cfg, unit_layers: int, max_batch: int, max_wait_ms: float, topk: int, max_q_len: int = 32,
                 replicas: int = 1, *, device="cuda", feature_stores=None):
    """Checkpoint + features + vocab -> (engine, answer_fn, stores).
    ``cfg.dataset.save_dir`` is already joined with ``exp_name``;
    ``feature_stores`` (an (appearance, motion) pair of FeatureStores)
    replaces the HDF5 files."""
    dev = resolve_device(device)
    model, vocab = model_from_checkpoint(cfg, unit_layers, device=dev)
    k = min(topk, len(vocab["answer_token_to_idx"]))
    devices = None
    if replicas > 1:
        predict, devices = _replicate(replicas, dev, model=model, topk=k)
    else:
        predict = build_predict_fn(model, k, device=dev)
    return _assemble(cfg, predict, max_batch, max_wait_ms, max_q_len, device=dev, devices=devices,
                     feature_stores=feature_stores)


class _Handler(BaseHTTPRequestHandler):
    # set on the server instance: .engine, .answer_fn
    def _send(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/stats":
            self._send(200, self.server.engine.stats())
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        if self.path != "/answer":
            self._send(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            video_id = str(payload["video_id"])
            question = str(payload["question"])
        except (KeyError, TypeError, ValueError) as e:
            self._send(400, {"error": f"bad request: {e}"})
            return
        try:
            self._send(200, self.server.answer_fn(video_id, question))
        except KeyError as e:
            self._send(404, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — a failed answer is the caller's 500, not the server's end
            logging.exception("inference error")
            self._send(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logging.info("%s %s", self.address_string(), fmt % args)


class _Server(ThreadingHTTPServer):
    # the engine batches concurrent callers: let a batch's worth and more
    # wait in the listen queue (socketserver's default is 5, beyond which
    # a connection may be refused or reset)
    request_queue_size = 256
    daemon_threads = True


def make_server(host: str, port: int, engine, answer_fn) -> ThreadingHTTPServer:
    srv = _Server((host, port), _Handler)
    srv.engine = engine
    srv.answer_fn = answer_fn
    return srv


def warm_up(engine, replicas: int, timeout: float = 600.0):
    """One request per replica (round-robin reaches each) before traffic."""
    app_shape, mot_shape = engine._feature_shapes
    for _ in range(max(1, replicas)):
        engine.submit(np.zeros(app_shape, np.float32), np.zeros(mot_shape, np.float32), np.array([1], np.int32),
                      timeout=timeout)


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve DualVGR answers over HTTP")
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--unit_layers", type=int, default=1)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--replicas", type=int, default=1,
                   help="serve N replicas, one per card, with round-robin dispatch")
    p.add_argument("--artifact", default=None,
                   help="serve a .dvgr export (python -m dualvgr_tpu_torch.export) instead of the checkpoint; "
                        "batch, question length and top-k come from its header")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    cfg = cfg_from_file(args.cfg_file)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    setup_logging()
    if args.artifact:
        engine, answer_fn, _stores = build_engine_from_artifact(cfg, args.artifact, args.max_wait_ms,
                                                                replicas=args.replicas, device=args.device)
    else:
        engine, answer_fn, _stores = build_engine(cfg, args.unit_layers, args.max_batch, args.max_wait_ms,
                                                  args.topk, replicas=args.replicas, device=args.device)
    logging.info("warming up...")
    warm_up(engine, args.replicas)
    srv = make_server(args.host, args.port, engine, answer_fn)
    logging.info("serving on %s:%d (max_batch=%d, max_wait=%.1fms)", args.host, args.port, engine.max_batch,
                 args.max_wait_ms)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        engine.close()
        for store in _stores:
            store.close()


if __name__ == "__main__":
    main()
