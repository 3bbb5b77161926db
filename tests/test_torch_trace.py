"""The port's tracer (``utils/trace.py``) and the spans and counters placed
in the train step, the loader and validation, on the CPU.

Off, the tracer hands out one shared no-op and records nothing; on, it
records names, nesting, threads and counters, shows each span as a range
of a running profile, and reading clears them. A
train step yields its forward, backward and optimizer spans (the model's
unit cycles inside the first, the clip and Adam inside the last), and a
forward one ``model.unit`` span and count a unit cycle; a loader pass yields its gathers and puts on the
producer thread and its gets on the consumer, with counters equal to the
batches' sizes; a validation pass yields one fetch a batch and one tally;
a ``predict_frames`` call its extraction spans once a video, its encode
and forward once, with counters equal to what it was given.
``prefetch_to_device`` is a pass-through on the CPU: its span and counters
are held on the card (``tests/test_torch_kernels_cuda.py``).
"""

import json
import pickle
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model, train_lib, validate_lib
from dualvgr_tpu_torch.data import FeatureStore, VideoQADataLoader
from dualvgr_tpu_torch.utils import trace

# in start order; the forward holds its model's unit cycle (one: unit_layers 1)
TRAIN_SPANS = ["train.forward", "model.unit", "train.backward", "train.optimizer", "optimizer.clip",
               "optimizer.adam"]
PARENTS = {"model.unit": "train.forward", "optimizer.clip": "train.optimizer", "optimizer.adam": "train.optimizer"}


@pytest.fixture(autouse=True)
def _tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    trace.disable()
    trace.spans(), trace.counters()
    yield
    trace.disable()
    trace.spans(), trace.counters()


def _by_start(spans):
    return sorted(spans, key=lambda s: s.start_ns)


# ---------------------------------------------------------------- the tracer

def _off():
    assert not trace.is_on()
    assert trace.span("a") is trace.span("b")
    with trace.span("a"):
        trace.count("c", 3)
    assert trace.spans() == [] and trace.counters() == {}


def _names_nesting_and_counters():
    trace.enable()
    assert trace.is_on()
    with trace.span("outer"):
        with trace.span("inner"):
            trace.count("c")
        trace.count("c", 4)
    trace.count("d", 2)
    trace.disable()
    got = _by_start(trace.spans())
    assert [(s.name, s.parent) for s in got] == [("outer", None), ("inner", "outer")]
    assert all(s.thread == threading.get_ident() and s.start_ns <= s.end_ns for s in got)
    assert got[0].start_ns <= got[1].start_ns and got[1].end_ns <= got[0].end_ns
    assert trace.counters() == {"c": 5, "d": 2}
    assert trace.spans() == [] and trace.counters() == {}  # read and cleared


def _threads():
    trace.enable()
    with trace.span("main"):
        t = threading.Thread(target=_one_span, args=("worker",))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    trace.disable()
    got = {s.name: s for s in trace.spans()}
    assert got["worker"].parent is None  # nesting is per thread
    assert got["worker"].thread != got["main"].thread == threading.get_ident()


def _one_span(name):
    with trace.span(name):
        pass


def _only_whole_sessions():
    early = trace.span("early")  # taken while off: the no-op
    trace.enable()
    with early:
        pass
    across = trace.span("across")
    across.__enter__()
    trace.disable()
    across.__exit__(None, None, None)  # ends after disable()
    trace.enable()
    again = trace.span("across_sessions")
    again.__enter__()
    trace.disable()
    trace.enable()
    again.__exit__(None, None, None)  # begun in an earlier session
    _one_span("whole")
    trace.disable()
    assert [(s.name, s.parent) for s in trace.spans()] == [("whole", None)]


def _annotate():
    """On, each span is a range of a running profile; off, none is."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable()
        with trace.span("annotated"):
            torch.ones(4).sum()
        trace.disable()
        with trace.span("after"):
            pass
    names = {e.name for e in prof.events()}
    assert "annotated" in names and "after" not in names
    assert [s.name for s in trace.spans()] == ["annotated"]


TRACER_CASES = {f.__name__.strip("_"): f for f in
                (_off, _names_nesting_and_counters, _threads, _only_whole_sessions, _annotate)}


@pytest.mark.parametrize("case", sorted(TRACER_CASES))
def test_the_tracer(case):
    TRACER_CASES[case]()


# ---------------------------------------------------------------- the train step

VISION, NODES, FRAMES, T, VOCAB, ANSWERS, B = 20, 4, 3, 6, 30, 9, 6


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    qlen = rng.randint(1, T + 1, (B,)).astype(np.int32)
    q = rng.randint(1, VOCAB, (B, T)).astype(np.int32) * (np.arange(T)[None] < qlen[:, None])
    return (rng.randn(B, NODES, FRAMES, VISION).astype(np.float32), rng.randn(B, NODES, VISION).astype(np.float32),
            q.astype(np.int32), qlen, rng.randint(0, ANSWERS, (B,)).astype(np.int32), np.ones(B, np.float32))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_train_step_yields_its_phases_in_order(grad_accum):
    model = build_model(device="cpu", vision_dim=VISION, module_dim=16, word_dim=10, question_vocab_size=VOCAB,
                        num_answers=ANSWERS, num_of_nodes=NODES, graph_layers=1, unit_layers=1)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 10, grad_accum=grad_accum))
    train_lib.train_step(state, _batch(0), alpha=1.0, beta=1e-8)  # untraced
    for step in range(grad_accum):
        trace.enable()
        train_lib.train_step(state, _batch(step + 1), alpha=1.0, beta=1e-8)
        trace.disable()
        got = _by_start(trace.spans())
        # the first micro-step of a window of 2 accumulates: no Adam step
        want = TRAIN_SPANS if (step + 2) % grad_accum == 0 else TRAIN_SPANS[:-1]
        assert [s.name for s in got] == want
        parents = {s.name: s.parent for s in got}
        assert parents == {n: PARENTS.get(n) for n in want}
        forward, unit, backward, optimizer = got[:4]
        assert forward.start_ns <= unit.start_ns <= unit.end_ns <= forward.end_ns
        assert all(optimizer.start_ns <= s.start_ns <= s.end_ns <= optimizer.end_ns for s in got[4:])
        assert forward.end_ns <= backward.start_ns and backward.end_ns <= optimizer.start_ns
        assert trace.counters() == {"train.eager_steps": 1, "model.unit_cycles": 1}
    assert state.updates == 1 + (grad_accum == 1)


@pytest.mark.parametrize("on", [True, False])
def test_a_two_unit_forward_traces_each_cycle(on):
    """Each unit cycle of a forward (unit_layers 2, 20 nodes) is one
    ``model.unit`` span, in order and apart, and counts one
    ``model.unit_cycles``; with the tracer off nothing is recorded."""
    model = build_model(device="cpu", vision_dim=VISION, module_dim=16, word_dim=10, question_vocab_size=VOCAB,
                        num_answers=ANSWERS, num_of_nodes=20, graph_layers=1, unit_layers=2)
    rng = np.random.RandomState(1)
    app, mot = rng.randn(2, 20, FRAMES, VISION), rng.randn(2, 20, VISION)
    q, qlen = rng.randint(1, VOCAB, (2, T)), np.full(2, T)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (app, mot)] + [torch.as_tensor(q), torch.as_tensor(qlen)]
    if on:
        trace.enable()
    model(*args)
    trace.disable()
    got = _by_start(trace.spans())
    if not on:
        assert got == [] and trace.counters() == {}
        return
    assert [(s.name, s.parent) for s in got] == [("model.unit", None)] * 2
    assert got[0].end_ns <= got[1].start_ns
    assert trace.counters() == {"model.unit_cycles": 2}


# ---------------------------------------------------------------- the loader and validation

QUESTIONS, VIDEOS = 70, 40


def _loader(tmp_path, batch_size):
    """A loader on in-memory stores: msvd-qa-style questions whose first
    tokens are the five bucket words."""
    rs = np.random.RandomState(5)
    ids = np.arange(100, 100 + VIDEOS)
    app = FeatureStore.from_array(ids, rs.randn(VIDEOS, 4, 3, 16).astype(np.float32), "resnet_features")
    mot = FeatureStore.from_array(ids, rs.randn(VIDEOS, 4, 16).astype(np.float32), "resnext_features")
    words = ["what", "who", "how", "when", "where"]
    vocab = {"question_token_to_idx": {"<NULL>": 0, "<UNK>": 1, **{w: i + 2 for i, w in enumerate(words)}},
             "answer_token_to_idx": {f"a{i}": i for i in range(6)}, "question_answer_token_to_idx": {}}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    qlen = rs.randint(1, 7, QUESTIONS)
    obj = {"questions": rs.randint(2, 7, (QUESTIONS, 6)) * (np.arange(6)[None] < qlen[:, None]),
           "questions_len": qlen, "question_id": np.arange(QUESTIONS), "video_ids": rs.choice(ids, QUESTIONS),
           "answers": rs.randint(0, 6, QUESTIONS)}
    with open(tmp_path / "q.pt", "wb") as f:
        pickle.dump(obj, f)
    return VideoQADataLoader(question_pt=str(tmp_path / "q.pt"), vocab_json=str(tmp_path / "vocab.json"),
                             appearance_feat=app, motion_feat=mot, batch_size=batch_size, shuffle=True)


@pytest.mark.parametrize("batch_size", [8, QUESTIONS])
def test_a_loader_pass_traces_its_producer_and_consumer(tmp_path, batch_size):
    loader = _loader(tmp_path, batch_size)
    trace.enable()
    batches = list(loader)
    trace.disable()
    n = len(loader)
    assert len(batches) == n
    got = trace.spans()
    me = threading.get_ident()
    by_name = {name: [s for s in got if s.name == name] for name in ("loader.gather", "loader.put", "loader.get")}
    assert sorted(s.name for s in got) == sorted(["loader.gather"] * n + ["loader.put"] * n + ["loader.get"] * (n + 1))
    producer = {s.thread for s in by_name["loader.gather"] + by_name["loader.put"]}
    assert len(producer) == 1 and me not in producer  # the sentinel's get is the last
    assert all(s.thread == me and s.parent is None for s in by_name["loader.get"])
    counters = trace.counters()
    assert counters["loader.batches"] == n
    assert counters["loader.rows"] == sum(len(b.valid) for b in batches) == n * batch_size
    assert counters["loader.bytes"] == sum(b.appearance_feat.nbytes + b.motion_feat.nbytes for b in batches)
    loader.close()


@pytest.mark.parametrize("write_preds", [False, True])
def test_a_validation_pass_fetches_each_batch_and_tallies_once(tmp_path, write_preds):
    loader = _loader(tmp_path, 8)
    cfg = SimpleNamespace(dataset=SimpleNamespace(name="msvd-qa"), tpu=SimpleNamespace(mesh_axis="data"))
    eval_fn = lambda state, inputs: torch.zeros(len(inputs[0]), dtype=torch.int64)
    trace.enable()
    out = validate_lib.validate(cfg, eval_fn, None, loader, write_preds=write_preds, device="cpu")
    trace.disable()
    names = [s.name for s in trace.spans() if s.name.startswith("validate.")]
    assert names == ["validate.fetch"] * len(loader) + ["validate.tally"]
    assert len(out) == (10 if write_preds else 6)
    loader.close()


# ---------------------------------------------------------------- the raw-video path

EXTRACT_SPANS = ["extract.upload", "extract.clips", "extract.appearance", "extract.motion"]
PREDICT_SPANS = ["predict.encode", "predict.forward"]


def test_predict_frames_traces_each_video_and_its_questions():
    """Two videos (one asked twice) through ``predict_frames`` at depth
    (1, 1, 1, 1) and small sizes: each extraction span once a video, in
    order, then the encode and the forward once; the counters are the
    videos, the frames and clips through the backbones, the frames' bytes
    and the questions the call was given."""
    from dualvgr_tpu_torch import predict
    from dualvgr_tpu_torch.preprocess.features import build_appearance_extractor, build_motion_extractor

    clips, words = 2, ["what", "is", "the", "man", "doing"]
    vocab = {"question_token_to_idx": {"<NULL>": 0, "<UNK>": 1, **{w: i + 2 for i, w in enumerate(words)}}}
    model = build_model(device="cpu", vision_dim=2048, module_dim=16, word_dim=8, question_vocab_size=len(words) + 2,
                        num_answers=5, num_of_nodes=clips, graph_layers=1, unit_layers=1)
    app_x = build_appearance_extractor(device="cpu", layers=(1, 1, 1, 1))
    mot_x = build_motion_extractor(device="cpu", layers=(1, 1, 1, 1))
    rng = np.random.RandomState(3)
    videos = [rng.randint(0, 256, (t, 20, 28, 3)).astype(np.uint8) for t in (9, 40)]
    questions = ["what is the man doing?", "what is the man", "is the man doing"]
    trace.enable()
    logits = predict.predict_frames([videos[0], videos[1], videos[1]], questions, model=model, vocab=vocab,
                                    app_extract=app_x, mot_extract=mot_x, num_clips=clips, appearance_size=24,
                                    motion_size=16, device="cpu")
    trace.disable()
    assert tuple(logits.shape) == (3, 5)
    got = [s for s in _by_start(trace.spans()) if s.name.startswith(("extract.", "predict."))]
    assert [s.name for s in got] == EXTRACT_SPANS * 2 + PREDICT_SPANS
    assert all(s.parent is None for s in got)
    counters = trace.counters()
    assert {k: v for k, v in counters.items() if k.startswith(("extract.", "predict."))} == {
        "extract.videos": 2, "extract.frames": 2 * clips * 16, "extract.clips": 2 * clips,
        "extract.upload_bytes": videos[0].nbytes + videos[1].nbytes, "predict.questions": 3}
