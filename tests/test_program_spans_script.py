"""``scripts/program_spans.py`` on the CPU: the harness's ``Recorder``
with the port's tracer on over the traced window, the card's idle gaps
labelled by the launching thread's innermost span (never by a span of
another thread), and its readings on spans built by hand, of eager steps
and of steps a CUDA graph replayed."""

import importlib.util
import threading
from pathlib import Path

import pytest
import torch

from dualvgr_tpu_torch.utils import trace
from dualvgr_tpu_torch.utils.trace import Span

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "program_spans.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("program_spans", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.spans(), trace.counters()
    yield
    trace.disable()
    trace.spans(), trace.counters()


def _ns(s):
    return int(s * 1e9)


ME, PRODUCER = 1, 2
# host seconds: a train step [0, 10) holding forward [0, 3), backward [3, 7),
# optimizer [7, 9.5) with clip [7.1, 9); the producer gathers over [2, 8)
HARNESS = [("train_step", 0.0, 10.0), ("metrics.read", 10.0, 11.0)]
PROGRAM = [Span("train.forward", _ns(0), _ns(3), ME, None), Span("train.backward", _ns(3), _ns(7), ME, None),
           Span("optimizer.clip", _ns(7.1), _ns(9), ME, "train.optimizer"),
           Span("train.optimizer", _ns(7), _ns(9.5), ME, None),
           Span("loader.gather", _ns(2), _ns(8), PRODUCER, None)]


@pytest.mark.parametrize("gap_at, label", [(1.0, "train.forward"), (2.5, "train.forward"),
                                           (5.0, "train.backward"), (8.0, "optimizer.clip"),
                                           (9.7, "train_step"), (10.5, "metrics.read"), (12.0, "outside any span")])
def test_a_gap_is_labelled_by_the_launching_threads_innermost_span(script, gap_at, label):
    from perfbench.lib.trace import breakdown

    # card ns = host ns: one gap of 1 us at ``gap_at`` in a busy window [0, 13 s)
    a = _ns(gap_at)
    busy = [(0, a), (a + 1000, _ns(13))]
    out = breakdown([("k", 0, a)], busy, (0, _ns(13)), script.with_program(HARNESS, PROGRAM, ME), 0)
    assert [g[0] for g in out["idle_gaps"]] == [label]


def test_readings_on_spans_by_hand(script):
    harness = HARNESS + [("eval.between", 20.0, 21.0), ("eval.between", 30.0, 30.5)]
    program = PROGRAM + [Span("validate.fetch", _ns(20), _ns(20.6), ME, None),
                         Span("prefetch.copy", _ns(20.6), _ns(20.8), ME, None),
                         Span("loader.get", _ns(30), _ns(30.3), ME, None),
                         Span("loader.get", _ns(31), _ns(32), ME, None)]  # after the interval: not its part
    kernels = [("Memcpy HtoD (Pinned -> Device)", 0.0, 0.5), ("k", 0.5, 1.0), ("Memcpy HtoD (Pinned -> Device)", 2, 1.5)]
    gaps = [["train.backward", 0.3], ["train_step", 0.1], ["metrics.read", 0.5]]
    got = script.readings(harness, program, {"prefetch.bytes": 4e9}, kernels, gaps)
    assert got["spans"]["train.backward"] == {"n": 1, "mean_ms": pytest.approx(4e3), "total_s": pytest.approx(4.0)}
    assert got["phases_of_train_step"] == pytest.approx((3 + 4 + 2.5) / 10)
    between = got["between"]
    assert between["validate.fetch"] == pytest.approx(0.6) and between["loader.get"] == pytest.approx(0.3)
    assert between["share"] == pytest.approx((0.6 + 0.2 + 0.3) / 1.5)
    assert got["h2d_gbps"] == pytest.approx(2.0)
    assert got["idle_in_program"] == pytest.approx(0.75)
    assert set(script.readings(HARNESS[1:], [], {}, [], [])) == {"spans", "counters"}  # nothing to read


@pytest.mark.parametrize("replayed, eager", [(3, 0), (2, 1), (0, 3)])
def test_readings_of_graph_replays(script, replayed, eager):
    """Three steps of 10 s, each either replayed (one ``train.graph_replay``
    of 8 s) or eager (the three phases, 9.5 s): the host phases are read
    from whichever ran, and the replay share from the counters."""
    harness, program = [], []
    for i in range(replayed + eager):
        t = 10.0 * i
        harness.append(("train_step", t, t + 10))
        if i < replayed:
            program.append(Span("train.graph_replay", _ns(t), _ns(t + 8), ME, None))
        else:
            program += [Span(s.name, s.start_ns + _ns(t), s.end_ns + _ns(t), ME, s.parent) for s in PROGRAM[:4]]
    counters = {"train.graph_replays": replayed, "train.eager_steps": eager}
    gaps = [["train.graph_replay", 0.3], ["train_step", 0.1]]
    got = script.readings(harness, program, counters, [], gaps)
    assert got["phases_of_train_step"] == pytest.approx((8 * replayed + 9.5 * eager) / (10 * (replayed + eager)))
    assert got["replay_share"] == pytest.approx(replayed / 3)
    assert got["counters"] == counters
    assert got["idle_in_program"] == pytest.approx(0.75)


def test_idle_under_a_unit_cycle_is_the_programs(script):
    """An eager step's forward holds its unit cycles: a gap labelled
    ``model.unit`` is idle the program holds, and the span and its counter
    are read."""
    program = [Span("train.forward", _ns(0), _ns(3), ME, None),
               Span("model.unit", _ns(1), _ns(2), ME, "train.forward")]
    got = script.readings(HARNESS, program, {"model.unit_cycles": 1}, [], [["model.unit", 0.3], ["train_step", 0.1]])
    assert got["idle_in_program"] == pytest.approx(0.75)
    assert got["spans"]["model.unit"] == {"n": 1, "mean_ms": pytest.approx(1e3), "total_s": pytest.approx(1.0)}
    assert got["counters"] == {"model.unit_cycles": 1}


def test_the_recorder_turns_the_tracer_on_over_its_window(script):
    rec = script.ProgramSpans(True, torch.device("cpu"), 0.0, 0.0)
    rec.begin_window()
    with trace.span("before"):  # not yet on
        pass
    rec.boundary()  # opens the window
    assert trace.is_on()
    with rec.span("train_step"), trace.span("train.forward"):
        trace.count("prefetch.bytes", 8)
    worker = threading.Thread(target=_gather)
    worker.start()
    worker.join(timeout=10)
    rec.boundary()  # closes it
    assert not trace.is_on()
    out = rec.data("train", {}, {})
    assert set(out.spans) == {"train_step", "train.forward", "loader.gather"}
    assert out.counters == {"program": {"prefetch.bytes": 8}}
    assert rec.readings["spans"]["loader.gather"]["n"] == 1
    assert 0 < rec.readings["phases_of_train_step"] <= 1


def _gather():
    with trace.span("loader.gather"):
        pass
