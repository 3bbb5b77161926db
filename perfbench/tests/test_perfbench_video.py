"""The raw-video cell on the CPU at a tiny size: the plain reference of
``reference/video.py`` against PIL and against the port, the driver's
comparison, and the cell's readers.

Sizes are built here: the backbones at their published widths but depth
(1, 1, 1, 1), 32^2 appearance and 16^2 motion inputs, a DualVGR that reads
the 2048-d features with small widths, a few short videos."""

import copy
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

from perfbench.drivers import predict as driver
from perfbench.lib import common
from perfbench.lib.harness import Context
from perfbench.lib.trace import TraceData
from perfbench.lib.video_weights import make_backbone_weights
from perfbench.reference import video as reference

CELL = "msrvtt-qa-video.predict"
LAYERS = (1, 1, 1, 1)
SEED = 2 ** 33 + 12345


def tiny_cell():
    workload = copy.deepcopy(common.workload(CELL))
    config = copy.deepcopy(common.config(workload["config"]))
    config["model"].update(module_dim=16, word_dim=8, question_vocab_size=40, num_answers=50, num_of_nodes=2,
                           question_len=6)
    config["backbones"]["appearance"]["layers"] = list(LAYERS)
    config["backbones"]["motion"]["layers"] = list(LAYERS)
    config["video"].update(num_clips=2, appearance_size=32, motion_size=16, frame_height=24, frame_width=40,
                           frames={"offset": 12, "mean": 8, "max": 40})
    config.update(test_videos=6, test_questions=21)
    config["question_length"] = {"offset": 2, "log_mean": 0.7, "log_sigma": 0.5, "max": 6}
    workload.update(pool_videos=3, warmup_calls=1, warmup_seconds=0.0, readings_calls=2)
    return workload, config


def run_tiny(*, variant=None, faults=(), readings_only=False, trace=False, seconds=0.3, **cell):
    workload, config = tiny_cell()
    workload.update(cell)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(CELL, workload, config, SEED, seconds, trace, torch.device("cpu"), tmp, variant=variant,
                      faults=tuple(faults), readings_only=readings_only)
        out = driver.run(ctx)
    out["ctx"] = ctx
    return out


def correct(result) -> bool:
    return all(c["ok"] for c in result["checks"]) and result["failed"] == 0


# ---------------------------------------------------------------- the reference

@pytest.mark.parametrize("size", [(24, 40, 32, 32), (240, 320, 224, 224), (240, 320, 112, 112), (7, 9, 20, 3),
                                  (50, 30, 50, 31)])
def test_the_resize_is_pils_bit_for_bit(size):
    h, w, out_h, out_w = size
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((out_w, out_h), Image.BICUBIC))
    got = reference.resize_bicubic(torch.from_numpy(img).permute(2, 0, 1), out_h, out_w).permute(1, 2, 0)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("total", [0, 1, 5, 16, 17, 40, 300, 444, 900])
def test_the_sampler_is_the_ports(total):
    from dualvgr_tpu_torch.preprocess.features import sample_clip_indices

    for clips in (2, 16):
        assert np.array_equal(reference.sample_clip_indices(total, clips, 16), sample_clip_indices(total, clips, 16))


def test_the_backbones_are_the_ports():
    """At published widths, depth (1, 1, 1, 1): the reference's functions
    on the port's extractors' inputs and weights, within 1e-5 relative."""
    from dualvgr_tpu_torch.preprocess.features import build_appearance_extractor, build_motion_extractor

    app_w = make_backbone_weights(reference.resnet101_spec(LAYERS), SEED, "appearance", "cpu")
    mot_w = make_backbone_weights(reference.resnext101_spec(LAYERS), SEED, "motion", "cpu", raw_input=True)
    app_x = build_appearance_extractor(device="cpu", layers=LAYERS)
    mot_x = build_motion_extractor(device="cpu", layers=LAYERS)
    app_x.model.load_state_dict(app_w)
    mot_x.model.load_state_dict(mot_w)
    rng = torch.Generator().manual_seed(5)
    frames = torch.randint(0, 256, (6, 3, 32, 32), generator=rng).float()
    clips = torch.randint(0, 256, (2, 3, 16, 16, 16), generator=rng).float()
    with torch.no_grad():
        for got, want in ((app_x(frames), reference.resnet101(app_w, frames, LAYERS)),
                          (mot_x(clips), reference.resnext101_3d(mot_w, clips, LAYERS))):
            assert got.shape == want.shape == (len(want), 2048)
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


def test_the_backbones_stay_of_order_one_through_all_their_blocks():
    """The seeded weights at full depth (3, 4, 23, 3), on small inputs: the
    pooled features are finite and of order 1 in both backbones."""
    app_w = make_backbone_weights(reference.resnet101_spec(), SEED, "appearance", "cpu")
    mot_w = make_backbone_weights(reference.resnext101_spec(), SEED, "motion", "cpu", raw_input=True)
    rng = torch.Generator().manual_seed(6)
    with torch.no_grad():
        app = reference.resnet101(app_w, torch.randint(0, 256, (2, 3, 32, 32), generator=rng).float())
        mot = reference.resnext101_3d(mot_w, torch.randint(0, 256, (1, 3, 16, 16, 16), generator=rng).float())
    for feats in (app, mot):
        assert torch.isfinite(feats).all()
        assert 0.1 < float(feats.abs().mean()) < 10.0 and float(feats.abs().max()) < 100.0


def test_predict_frames_is_the_reference_end_to_end():
    """The driver's program and the reference's whole path on one stamped
    video and its questions, within the cell's limits."""
    out = run_tiny(readings_only=True)
    assert correct(out), out["checks"]
    gaps = {c["name"]: c["value"] for c in out["checks"]}
    assert gaps["logit_rel_gap"] < 1e-5 and gaps["answer_logit_gap"] == 0.0


# ---------------------------------------------------------------- the driver

def test_a_tiny_run_is_correct():
    out = run_tiny()
    assert correct(out), out["checks"]
    assert out["attempted"] > 0 and out["e2e"]["eval_qa_per_s"] > 0
    assert out["window"][1] > out["window"][0]


def test_the_bf16_control_is_not():
    out = run_tiny(variant="control", readings_only=True)
    assert not correct(out), out["checks"]


def test_an_altered_answer_is_not():
    out = run_tiny(faults=("answer",), readings_only=True)
    assert not correct(out), out["checks"]


def test_every_call_sees_other_pixels():
    pool = [np.zeros((3, 20, 20, 3), np.uint8)]
    seen = {driver.stamp(pool[0], k).tobytes() for k in (0, 1, 255, 256, 65536, 2 ** 24 - 1)}
    assert len(seen) == 6


def test_the_traffic_is_the_seeds():
    _, config = tiny_cell()
    a, b = (driver.video_lengths(config["video"], 24, s) for s in (SEED, SEED + 1))
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert a.min() >= 12 and a.max() <= 40
    split, texts = driver.questions_of(config, SEED)
    assert len(texts) == split.num_questions == 21
    vocab = split.vocab["question_token_to_idx"]
    for text, row, n in zip(texts, split.questions, split.lengths):
        assert [vocab[w] for w in text[:-1].split()] == list(row[:n])


# ---------------------------------------------------------------- the readers

def _trace(program):
    config = common.config("msrvtt-qa-video")
    counters = {} if program is None else {"program": program}
    return TraceData("predict", config, {}, window_s=2.0, host_window_s=2.0, busy_s=1.5, counters=counters,
                     timings={"predict_frames": [150.0, 160.0]})


def test_the_readers_read_the_programs_spans_and_counters():
    from perfbench.lib.backbone_flops import resnet101_flops, resnext101_3d_flops

    program = {"counters": {"extract.frames": 512, "extract.clips": 32, "extract.upload_bytes": 4 * 10 ** 9},
               "spans": {"extract.upload": [0.1, 0.3]}}
    trace = _trace(program)
    flops = 512 * resnet101_flops() + 32 * resnext101_3d_flops()
    assert common.reader("extract.mfu.predict")(trace) == pytest.approx(100 * flops / 2.0 / 165e12)
    assert common.reader("extract.mfu.predict")(trace) == pytest.approx(100 * 2 * 4.2994117e12 / 2.0 / 165e12)
    assert common.reader("extract.upload_gbps.predict")(trace) == pytest.approx(10.0)
    assert common.reader("predict_call.ms")(trace) == pytest.approx(155.0)
    assert common.reader("device.idle_share.predict")(trace) == pytest.approx(25.0)


@pytest.mark.parametrize("program", [None, {"counters": {}, "spans": {}}])
def test_the_readers_give_none_without_the_programs_counters(program):
    trace = _trace(program)
    assert common.reader("extract.mfu.predict")(trace) is None
    assert common.reader("extract.upload_gbps.predict")(trace) is None


def test_a_traced_run_hands_the_programs_spans_to_the_readers():
    """A traced run on the CPU: the port's tracer is on over the traced
    window, so its counters hold whole calls."""
    out = run_tiny(trace=True, seconds=1.0, trace_from=0.0, trace_to=0.5)
    trace = out["ctx"].rec.data("predict", tiny_cell()[1], tiny_cell()[0])
    program = trace.counters["program"]
    calls = len(trace.steps)
    assert calls > 0
    clips = tiny_cell()[1]["video"]["num_clips"]
    assert program["counters"]["extract.videos"] == calls
    assert program["counters"]["extract.frames"] == calls * clips * 16
    assert program["counters"]["extract.clips"] == calls * clips
    assert program["counters"]["predict.questions"] == sum(s["questions"] for s in trace.steps)
    assert len(program["spans"]["extract.upload"]) == calls == len(trace.timings["predict_frames"])
