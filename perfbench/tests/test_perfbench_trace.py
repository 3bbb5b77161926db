"""The trace arithmetic: busy time as a union, idle gaps labelled by the
host span they began in, and the readers on a trace built by hand."""

import pytest

from perfbench.lib import common
from perfbench.lib.trace import TraceData, breakdown, merge, place_markers


def test_merge_is_a_union():
    assert merge([(5, 7), (0, 2), (1, 3), (7, 9), (4, 4)]) == [(0, 3), (5, 9)]


def test_idle_gaps_by_host_span():
    # card ns = host ns + 1000; busy [0, 100) and [300, 400) of a window [0, 500)
    ops = [("k_a", 0, 100), ("k_b", 300, 100)]
    busy = merge([(0, 100), (300, 400)])
    spans = [("loader.wait", -1000e-9, -800e-9), ("train_step", -850e-9, -400e-9)]
    out = breakdown(ops, busy, (0, 500), spans, 1000)
    assert out["device_ops"] == [["k_a", 1e-7], ["k_b", 1e-7]]
    # the gap at 100 ns (host -900) began in loader.wait; the one at 400 (host -600) in train_step
    assert dict(map(tuple, out["idle_gaps"])) == {"loader.wait": pytest.approx(2e-7), "train_step": pytest.approx(1e-7)}


def trace_for(cell):
    workload = common.workload(cell)
    return TraceData(workload["driver"], common.config(workload["config"]), workload)


def test_readers_on_a_trace_by_hand():
    t = trace_for("msrvtt-qa.train")
    t.window_s, t.host_window_s, t.busy_s = 1.9, 2.0, 1.5  # the card's clock a little off the host's
    t.spans["loader.wait"] = [0.001, 0.003]
    t.timings["train_step"] = [80.0, 90.0]
    t.steps = [{"rows": 256, "valid": 256, "qlen_sum": 1900, "q_pad": 24}] * 10
    read = lambda name: common.reader(name)(t)
    assert read("loader.wait_ms.train") == pytest.approx(2.0)
    assert read("train_step.ms") == pytest.approx(85.0)
    assert read("device.idle_share.train") == pytest.approx(100 * (1 - 1.5 / 1.9))
    assert read("train.mfu") == pytest.approx(100 * 9.644452032e9 * 2560 / 2.0 / 165e12)
    assert read("k3_train_fwd_roofline.train") is None


def test_batcher_rows_from_the_engine_counts():
    t = trace_for("msrvtt-qa.serve")
    t.counters = {"start": {"requests": 100, "batches": 10}, "stop": {"requests": 400, "batches": 25}}
    assert common.reader("batcher.rows_per_batch")(t) == pytest.approx(20.0)
    t.counters = {}
    assert common.reader("batcher.rows_per_batch")(t) is None


@pytest.mark.parametrize("kept", ["first", "last"])
def test_a_lost_marker_is_placed_by_the_host_interval(kept):
    # markers launched 1,000 ns apart on the host; work between them on the card
    work = [("k", 5100 + 100 * i, 50) for i in range(8)]
    mark = (5000, 10) if kept == "first" else (6000, 10)
    events = work + [("spin_kernel", *mark)]
    assert place_markers([mark], events, [70_000, 71_000]) == [(5000, 10), (6000, 10)]


def test_no_marker_cannot_place_the_window():
    with pytest.raises(RuntimeError, match="0 marker kernels"):
        place_markers([], [("k", 0, 5)], [0, 1000])
