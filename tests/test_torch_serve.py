"""The port's deployment path on the CPU: the HTTP front, the artifact route,
replicas and the checkpoint interchange, against the JAX package.

On the conftest ``synth_dir`` SVQA fixture: the JAX package's ``serve.py``
serves a JAX checkpoint, and ``dualvgr_tpu_torch.serve`` serves a port
checkpoint made from the same weights through ``from_jax_variables``
(``--device cpu``) and, through the artifact route, the program that
``python -m dualvgr_tpu_torch.export --platforms cpu`` wrote from it.
The same questions, POSTed from concurrent threads as text (their token
ids through the vocab), get the same answers: top-k scores within 1e-5
of the JAX server's, top-1 ids equal except where the JAX top two scores
lie within 1e-5 (fp32 in another sum order); the artifact route's scores
within 1e-6 of the checkpoint route's (the same graph, traced). Then the
status codes (400 bad body, 404 unknown video or path), ``/healthz``,
``/stats``, ``ReplicatedEngine``'s round robin and stats, the refusal of
replicas on the CPU, and ``port_reference``: import, serve, export gives
the reference ``.pt``'s state_dict bit for bit, with the model_kwargs the
JAX package's converter infers.
"""

import json
import os
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

import serve as jax_serve
from dualvgr_tpu import train_lib as jax_train_lib
from dualvgr_tpu.config import cfg_from_file as jax_cfg_from_file
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dualvgr_tpu.utils.port_reference import convert_reference_checkpoint as jax_convert_reference
from dualvgr_tpu_torch import ReplicatedEngine, build_model, create_train_state, make_optimizer
from dualvgr_tpu_torch import export as texport
from dualvgr_tpu_torch import serve as tserve
from dualvgr_tpu_torch.config import cfg_from_file
from dualvgr_tpu_torch.data.vocab import load_vocab
from dualvgr_tpu_torch.utils import port_reference
from dualvgr_tpu_torch.utils.checkpoint import save_checkpoint
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_cli import write_cfg
from test_torch_model import random_variables

SYN_KW = dict(vision_dim=32, module_dim=32, word_dim=16, num_of_nodes=4, graph_layers=1, graph_module="GAT")
MAX_BATCH, TOPK, N_QUESTIONS = 4, 3, 12


def _cfg(load, path):
    cfg = load(path)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    return cfg


def _start(engine, answer_fn):
    srv = tserve.make_server("127.0.0.1", 0, engine, answer_fn)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _request(port, path, body=None):
    """(status, JSON reply) of a GET, or of a POST of ``body`` (bytes)."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST" if body else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_all(port, questions):
    """POST every (video_id, question) from its own thread; the replies in order."""
    out = [None] * len(questions)

    def call(i):
        vid, text = questions[i]
        out[i] = _request(port, "/answer", json.dumps({"video_id": vid, "question": text}).encode())

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(questions))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def servers(synth_dir, tmp_path_factory):
    """JAX server on a JAX checkpoint; port servers on a port checkpoint of
    the same weights and on its exported artifact. Yields (ports by name,
    questions, vocab, the port's config path)."""
    root = tmp_path_factory.mktemp("serve")
    for side in ("jax", "port"):
        (root / side).mkdir()
    vocab = load_vocab(synth_dir["vocab"])
    sizes = dict(question_vocab_size=len(vocab["question_token_to_idx"]),
                 num_answers=len(vocab["answer_token_to_idx"]), unit_layers=1)
    jmodel = JaxDualVGR(**sizes, **SYN_KW)
    example = (np.zeros((1, 4, 3, 32), np.float32), np.zeros((1, 4, 32), np.float32),
               np.ones((1, 32), np.int32), np.full((1,), 32, np.int32))
    variables = random_variables(jmodel, example, seed=4)

    jax_path = write_cfg(synth_dir, str(root / "jax"))
    jcfg = _cfg(jax_cfg_from_file, jax_path)
    state = jax_train_lib.create_train_state(jmodel, jax.random.PRNGKey(0), example,
                                             jax_train_lib.make_optimizer(1e-3, 1))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    jax_save_checkpoint(os.path.join(jcfg.dataset.save_dir, "ckpt"), 0, state, SYN_KW)

    port_path = write_cfg(synth_dir, str(root / "port"))
    pcfg = _cfg(cfg_from_file, port_path)
    model = build_model(device="cpu", **sizes, **{k: v for k, v in SYN_KW.items() if k != "graph_module"})
    model.load_state_dict(from_jax_variables(variables))
    save_checkpoint(os.path.join(pcfg.dataset.save_dir, "ckpt"), 0,
                    create_train_state(model, make_optimizer(1e-3, 1)), {**SYN_KW, "unit_layers": 1})
    artifact = str(root / "port.dvgr")
    texport.main(["--cfg", port_path, "--out", artifact, "--max-batch", str(MAX_BATCH), "--topk", str(TOPK),
                  "--platforms", "cpu"])

    engines = {
        "jax": jax_serve.build_engine(jcfg, unit_layers=1, max_batch=MAX_BATCH, max_wait_ms=20.0, topk=TOPK),
        "port": tserve.build_engine(pcfg, 1, MAX_BATCH, 20.0, TOPK, device="cpu"),
        "artifact": tserve.build_engine_from_artifact(pcfg, artifact, 20.0, device="cpu"),
    }
    servers = {}
    for name, (engine, answer_fn, _) in engines.items():
        tserve.warm_up(engine, 1)
        servers[name] = _start(engine, answer_fn)

    with open(os.path.join(synth_dir["dir"], "svqa_test_questions.pt"), "rb") as f:
        obj = pickle.load(f)
    words = vocab["question_idx_to_token"]
    questions = [(str(v), " ".join(words[int(w)] for w in q[:n]) + "?")
                 for v, q, n in zip(obj["video_ids"], obj["questions"], obj["questions_len"])][:N_QUESTIONS]
    try:
        yield {k: s.server_address[1] for k, s in servers.items()}, questions, vocab, port_path
    finally:
        for name, srv in servers.items():
            srv.shutdown()
            srv.server_close()
            engine, _, stores = engines[name]
            engine.close()
            for store in stores:
                store.close()


def _answers(replies):
    for code, out in replies:
        assert code == 200, out
    ids = [[t["answer"] for t in out["topk"]] for _, out in replies]
    scores = np.array([[t["score"] for t in out["topk"]] for _, out in replies])
    return [out["answer"] for _, out in replies], ids, scores


def test_http_answers_match_the_jax_server(servers):
    ports, questions, vocab, _ = servers
    want, want_ids, want_scores = _answers(_post_all(ports["jax"], questions))
    got, got_ids, got_scores = _answers(_post_all(ports["port"], questions))
    assert set(got) <= set(vocab["answer_token_to_idx"]) and got_scores.shape == (N_QUESTIONS, TOPK)
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-5)
    tie = want_scores[:, 0] - want_scores[:, 1] <= 1e-5
    assert all(g == w or t for g, w, t in zip(got, want, tie))
    assert all(ids[0] == a for ids, a in zip(got_ids, got))


def test_http_artifact_route_matches_the_checkpoint_route(servers):
    ports, questions, _, _ = servers
    want, want_ids, want_scores = _answers(_post_all(ports["port"], questions))
    got, got_ids, got_scores = _answers(_post_all(ports["artifact"], questions))
    assert got == want and got_ids == want_ids
    np.testing.assert_allclose(got_scores, want_scores, rtol=0, atol=1e-6)


def test_http_status_codes_health_and_stats(servers):
    ports, questions, _, _ = servers
    port = ports["port"]
    assert _request(port, "/healthz") == (200, {"ok": True})
    assert _request(port, "/nowhere")[0] == 404
    vid, text = questions[0]
    assert _request(port, "/answer", json.dumps({"video_id": "999999", "question": text}).encode())[0] == 404
    assert _request(port, "/answer", json.dumps({"video_id": "no-such-id", "question": text}).encode())[0] == 404
    assert _request(port, "/answer", json.dumps({"question": "no video"}).encode())[0] == 400
    assert _request(port, "/answer", b"{not json")[0] == 400
    assert _request(port, "/other", json.dumps({"video_id": vid, "question": text}).encode())[0] == 404
    # a question with words outside the vocab and no question mark is answered
    code, out = _request(port, "/answer", json.dumps({"video_id": vid, "question": "Zebra's cat, what"}).encode())
    assert code == 200 and out["topk"][0]["answer"] == out["answer"]
    code, stats = _request(port, "/stats")
    assert code == 200 and stats["requests"] >= 2 and stats["latency_ms_p50"] is not None


def _np_predict(app, mot, q, qlen):
    """Per-row checksums, as tests/test_serving.py's stand-in."""
    app, mot, q, qlen = (np.asarray(x) for x in (app, mot, q, qlen))
    b = app.shape[0]
    ids = (app.reshape(b, -1).sum(1) + mot.reshape(b, -1).sum(1) + qlen).astype(np.int64)
    return ids, np.stack([q.sum(1), qlen], axis=1).astype(np.float32)


def test_replicated_engine_round_robin_and_stats():
    rng = np.random.RandomState(0)
    hits = [0, 0]

    def make(i):
        def fn(*args):
            hits[i] += 1
            return _np_predict(*args)
        return fn

    with ReplicatedEngine([make(0), make(1)], device="cpu", max_batch=2, max_wait_ms=1.0, max_q_len=6,
                          feature_shapes=((2, 3, 8), (2, 8))) as eng:
        assert eng.max_batch == 2 and eng.replicas == 2
        reqs = [(rng.randn(2, 3, 8).astype(np.float32), rng.randn(2, 8).astype(np.float32),
                 rng.randint(1, 30, (3,)).astype(np.int32)) for _ in range(6)]
        outs = [eng.submit(*r) for r in reqs]
        for (app, mot, q), (got_id, got_scores) in zip(reqs, outs):
            want_id, want_scores = _np_predict(app[None], mot[None], np.pad(q, (0, 3))[None], np.array([3]))
            assert int(got_id) == int(want_id[0])
            np.testing.assert_array_equal(got_scores, want_scores[0])
        s = eng.stats()
    assert hits == [3, 3]
    assert s["replicas"] == 2 and s["requests"] == 6 and s["batches"] == 6 and s["mean_batch"] == 1.0
    assert [p["requests"] for p in s["per_replica"]] == [3, 3] and s["latency_ms_p50"] is not None
    with pytest.raises(ValueError, match="at least one"):
        ReplicatedEngine([], device="cpu")
    with pytest.raises(ValueError, match="devices"):
        ReplicatedEngine([make(0)], devices=["cpu", "cpu"])


def test_engine_staging_resets_the_rows_a_larger_batch_left():
    """A batch of 1 after a batch of 3 in the reused staging tensors: its
    padding rows are zero features, token 0 and length 1 again, as a fresh
    padded batch; its own row keeps no token of the longer question
    before it."""
    from dualvgr_tpu_torch.serving import BatchingEngine, Request

    seen = []

    def record(*args):
        seen.append(tuple(np.array(x) for x in args))
        return _np_predict(*args)

    rng = np.random.RandomState(1)
    req = lambda n: Request(rng.randn(2, 3, 8).astype(np.float32), rng.randn(2, 8).astype(np.float32),
                            rng.randint(1, 30, (n,)).astype(np.int32))
    with BatchingEngine(record, device="cpu", max_batch=4, max_q_len=6) as eng:
        first = [req(5) for _ in range(3)]
        eng._step(first)
        second = req(2)
        ids, _ = eng._step([second])
    app, mot, q, qlen = seen[1]
    assert seen[0][3].tolist() == [5, 5, 5, 1]
    np.testing.assert_array_equal(app[0], second.appearance)
    assert not app[1:].any() and not mot[1:].any() and not q[1:].any() and qlen[1:].tolist() == [1, 1, 1]
    assert qlen[0] == 2 and q[0, :2].tolist() == second.question.tolist() and not q[0, 2:].any()
    assert ids.shape == (1,)


def test_replicas_are_placed_on_cards_only(servers):
    _, _, _, port_path = servers
    cfg = _cfg(cfg_from_file, port_path)
    with pytest.raises(ValueError, match="replicas"):
        tserve.build_engine(cfg, 1, MAX_BATCH, 1.0, TOPK, replicas=2, device="cpu")


def test_port_reference_round_trip_is_bit_exact(synth_dir, tmp_path):
    """A random-weight reference .pt -> import -> serve -> export: the same
    state_dict, bit for bit; the imported model_kwargs are the JAX
    converter's."""
    vocab = load_vocab(synth_dir["vocab"])
    sizes = dict(question_vocab_size=len(vocab["question_token_to_idx"]),
                 num_answers=len(vocab["answer_token_to_idx"]))
    jmodel = JaxDualVGR(**sizes, unit_layers=1, **SYN_KW)
    example = (np.zeros((1, 4, 3, 32), np.float32), np.zeros((1, 4, 32), np.float32),
               np.ones((1, 20), np.int32), np.full((1,), 20, np.int32))
    sd = from_jax_variables(random_variables(jmodel, example, seed=9))
    ref_kwargs = {k: v for k, v in SYN_KW.items() if k != "num_of_nodes"}
    pt = str(tmp_path / "ref_model.pt")
    torch.save({"epoch": 7, "state_dict": sd, "optimizer": None, "model_kwargs": ref_kwargs}, pt)

    cfg_path = write_cfg(synth_dir, str(tmp_path))
    cfg = _cfg(cfg_from_file, cfg_path)
    ckpt_dir = os.path.join(cfg.dataset.save_dir, "ckpt")
    with pytest.raises(ValueError, match="num_of_nodes"):
        port_reference.main(["import", pt, ckpt_dir, "--device", "cpu"])
    kw = port_reference.main(["import", pt, ckpt_dir, "--num_of_nodes", "4", "--device", "cpu"])
    want_kw = jax_convert_reference(pt, str(tmp_path / "jax_ckpt"), num_of_nodes=4)
    assert kw == want_kw
    assert json.load(open(os.path.join(ckpt_dir, "model", "meta.json")))["epoch"] == 7

    engine, answer_fn, stores = tserve.build_engine(cfg, 1, MAX_BATCH, 1.0, TOPK, device="cpu")
    try:
        out = answer_fn(next(iter(stores[0].id_to_index)), "what is word7 doing?")
        assert out["answer"] in vocab["answer_token_to_idx"] and len(out["topk"]) == TOPK
    finally:
        engine.close()

    back = str(tmp_path / "back_model.pt")
    written = port_reference.main(["export", ckpt_dir, back, "--device", "cpu"])
    ck = torch.load(back, map_location="cpu", weights_only=True)
    assert ck["epoch"] == 7 and ck["optimizer"] is None and ck["model_kwargs"] == written
    assert written == {**ref_kwargs, "num_of_nodes": 4}
    assert ck["state_dict"].keys() == sd.keys()
    for k, v in sd.items():
        got = ck["state_dict"][k]
        assert got.dtype == v.dtype and torch.equal(got, v), k


def test_feature_store_row_is_the_gathered_row(synth_dir):
    """``FeatureStore.row`` (the HTTP front's read of one video) gives the
    row ``gather`` gives, from an HDF5 store cached or not and from an
    in-memory one; an unknown id raises KeyError (the front's 404)."""
    from dualvgr_tpu_torch.data.features import FeatureStore

    cached = FeatureStore(synth_dir["appearance"], "resnet_features")
    on_disk = FeatureStore(synth_dir["appearance"], "resnet_features", cache_gb=0.0)
    ids = list(cached.id_to_index)
    memory = FeatureStore.from_array(np.asarray(ids, np.int64), cached.gather(np.arange(len(ids))),
                                     "resnet_features")
    try:
        for store in (cached, on_disk, memory):
            for vid in (ids[0], ids[-1], ids[len(ids) // 2]):
                want = cached.gather(cached.rows_for_video_ids([vid]))[0]
                assert torch.equal(store.row(vid), want)
            with pytest.raises(KeyError):
                store.row("987654")
    finally:
        on_disk.close()
