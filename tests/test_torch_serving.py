"""The port's serving path: BatchingEngine around build_predict_fn.

Concurrent requests through the engine (on the CPU) are answered, and their
top-k ids equal those of the JAX package's ``export.build_predict_fn`` on
the same weights and inputs; the scores agree at atol 1e-5.
"""

import threading

import numpy as np
import pytest
import torch

from dualvgr_tpu.export import build_predict_fn as jax_build_predict_fn
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import BatchingEngine, build_model, build_predict_fn
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import T, VISION, VOCAB, dims, inputs, random_variables

TOP_K = 3


def test_engine_answers_like_jax_predict_fn():
    nodes, frames, n_req, max_batch = 4, 3, 10, 4
    kw = dims(1, 1, nodes)
    jmodel = JaxDualVGR(**kw)
    variables = random_variables(jmodel, inputs(nodes, f=frames))
    model = build_model(device="cpu", **kw)
    model.load_state_dict(from_jax_variables(variables))

    rng = np.random.RandomState(5)
    reqs = [
        (rng.randn(nodes, frames, VISION).astype(np.float32),
         rng.randn(nodes, VISION).astype(np.float32),
         rng.randint(1, VOCAB, (1 + i % T,)).astype(np.int32))
        for i in range(n_req)
    ]
    results = [None] * n_req
    with BatchingEngine(
        build_predict_fn(model, TOP_K, device="cpu"), device="cpu", max_batch=max_batch,
        max_wait_ms=50.0, max_q_len=T, feature_shapes=((nodes, frames, VISION), (nodes, VISION)),
    ) as eng:
        def call(i):
            results[i] = eng.submit(*reqs[i])

        threads = [threading.Thread(target=call, args=(i,)) for i in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        stats = eng.stats()
    assert stats["requests"] == n_req
    assert stats["batches"] >= -(-n_req // max_batch)

    # the JAX serving program on the same requests, padded the same way
    app = np.stack([r[0] for r in reqs])
    mot = np.stack([r[1] for r in reqs])
    q = np.zeros((n_req, T), np.int32)
    qlen = np.array([len(r[2]) for r in reqs], np.int32)
    for i, r in enumerate(reqs):
        q[i, : len(r[2])] = r[2]
    want_ids, want_scores = (np.asarray(a) for a in jax_build_predict_fn(jmodel, variables, TOP_K)(app, mot, q, qlen))
    for i, (ids, scores) in enumerate(results):
        assert ids.shape == scores.shape == (TOP_K,)
        np.testing.assert_array_equal(ids, want_ids[i])
        np.testing.assert_allclose(scores, want_scores[i], atol=1e-5)


def test_engine_fans_errors_out_and_rejects_bad_requests():
    def boom(*_):
        raise RuntimeError("predict failed")

    with BatchingEngine(boom, device="cpu", max_batch=2, max_q_len=4,
                        feature_shapes=((2, 3), (2,))) as eng:
        with pytest.raises(RuntimeError, match="predict failed"):
            eng.submit(np.zeros((2, 3)), np.zeros((2,)), [1, 2])
        with pytest.raises(ValueError, match="max_q_len"):
            eng.submit(np.zeros((2, 3)), np.zeros((2,)), [1] * 5)
        with pytest.raises(ValueError, match="appearance shape"):
            eng.submit(np.zeros((3, 3)), np.zeros((2,)), [1])


def test_predict_fn_gets_padded_tensors_on_the_engine_device():
    seen = {}

    def spy(app, mot, q, qlen):
        seen.update(app=app, q=q, qlen=qlen)
        return torch.arange(app.shape[0]), np.zeros((app.shape[0], 2))

    with BatchingEngine(spy, device="cpu", max_batch=4, max_q_len=5) as eng:
        ids, scores = eng.submit(np.ones((2, 3)), np.ones((2,)), [7, 8])
    assert isinstance(seen["app"], torch.Tensor) and seen["app"].device.type == "cpu"
    assert tuple(seen["app"].shape) == (4, 2, 3)
    assert seen["q"][0].tolist() == [7, 8, 0, 0, 0]
    assert seen["qlen"].tolist() == [2, 1, 1, 1]
    assert int(ids) == 0 and scores.shape == (2,)
