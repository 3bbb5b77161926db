"""``train_lib.train_step``'s choice between the eager step and the CUDA
graph, on the CPU (the graph itself needs the card:
``tests/test_torch_train_graph_cuda.py``).

A step on the CPU or under gradient accumulation is eager and counted as
such, and so is one outside training mode (a state placed on a mesh: ``eager`` of the
ranks in ``tests/test_torch_multiprocess.py``); each step returns metrics
of its own, and so does each clone of a graph's packed metrics; one batch
key serves batches that differ in their values or in ``valid``, and not
batches of another shape; an Adam made capturable holds its learning rate
in one tensor that the host writes only when the schedule changes it.
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model, train_lib
from dualvgr_tpu_torch.parallel.dryrun import TINY, tiny_batches
from dualvgr_tpu_torch.utils import trace


def _state(grad_accum=1, steps_per_epoch=10, lr=1e-3):
    model = build_model(device="cpu", seed=0, **TINY)
    return train_lib.create_train_state(
        model, train_lib.make_optimizer(lr, steps_per_epoch, grad_accum=grad_accum), seed=3)


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.spans(), trace.counters()
    yield
    trace.disable()
    trace.spans(), trace.counters()


@pytest.mark.parametrize("case, reason", [("cpu", "on cpu"), ("accumulating", "gradient accumulation")])
def test_a_step_no_graph_can_take_runs_eagerly(case, reason):
    state = _state(grad_accum=2 if case == "accumulating" else 1)
    batches = tiny_batches(3, seed=5)
    trace.enable()
    for b in batches:
        train_lib.train_step(state, b, alpha=1.0, beta=1e-8)
        assert train_lib.eager_reason(state) == reason
    trace.disable()
    counters = trace.counters()
    assert counters.get("train.eager_steps") == len(batches)
    assert "train.graph_captures" not in counters and "train.graph_replays" not in counters
    assert state.graphs == {} and state.step == len(batches)
    state.model.eval()
    assert train_lib.eager_reason(state) == ("not in training mode" if case == "cpu" else reason)
    state.placement = object()  # placed on a mesh: eager before anything else is asked
    assert train_lib.eager_reason(state) == "placed on a mesh"


def test_each_step_returns_metrics_of_its_own():
    state = _state()
    first, second = (train_lib.train_step(state, b, alpha=1.0, beta=1e-8) for b in tiny_batches(2, seed=6))
    kept = {k: v.clone() for k, v in first.items()}
    train_lib.train_step(state, tiny_batches(1, seed=7)[0], alpha=1.0, beta=1e-8)
    for k in kept:
        assert torch.equal(first[k], kept[k]) and first[k].untyped_storage().data_ptr() != \
            second[k].untyped_storage().data_ptr()
    # a graph's metrics: one packed tensor, a fresh clone per replay
    packed = train_lib._pack(first)
    got = train_lib._unpack_metrics(packed.clone())
    packed.zero_()
    assert set(got) == set(first) and all(torch.equal(got[k], kept[k]) for k in kept)
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 8


def _with(batch, i, value):
    out = list(batch)
    out[i] = value
    return tuple(out)


@pytest.mark.parametrize("change, same", [
    ("values", True), ("valid", True), ("question width", False), ("batch size", False), ("dtype", False)])
def test_the_batch_key(change, same):
    base = tiny_batches(1, seed=8)[0]
    other = {
        "values": tiny_batches(1, seed=9)[0],
        "valid": tiny_batches(1, seed=8, pad=3)[0],
        "question width": _with(base, 2, np.pad(base[2], ((0, 0), (0, 2)))),
        "batch size": tiny_batches(1, batch=6, seed=8)[0],
        "dtype": _with(base, 0, base[0].astype(np.float64)),
    }[change]
    assert (train_lib.batch_key(other) == train_lib.batch_key(base)) is same
    as_tensors = lambda b: train_lib.batch_key(tuple(torch.as_tensor(a) for a in b))
    assert (as_tensors(other) == as_tensors(base)) is same


def test_adam_made_capturable_holds_its_rate_in_one_tensor_written_on_change():
    """After an eager step, Adam turned capturable (as ``train_step`` turns
    it before a capture): float64 counts, and a learning-rate tensor that
    the host writes only when the schedule (one step an epoch, halved at
    update 10) changes the rate."""
    state = _state(steps_per_epoch=1)
    train_lib.train_step(state, tiny_batches(1, seed=10)[0], alpha=1.0, beta=1e-8)
    assert state.adam.param_groups[0]["lr"] == 1e-3 and state.lr_on_device is None
    train_lib._make_capturable(state.adam, torch.device("cpu"))
    assert all(st["step"].dtype == torch.float64 and float(st["step"]) == 1 for st in state.adam.state.values())
    train_lib._write_lr(state)
    lr = state.adam.param_groups[0]["lr"]
    seen = []
    for updates in range(1, 12):
        state.updates = updates
        before = lr._version
        train_lib._write_lr(state)
        assert state.adam.param_groups[0]["lr"] is lr and state.lr_on_device == (lr, state.optimizer.lr(updates))
        seen.append((float(lr), lr._version - before))
    assert seen == [(pytest.approx(1e-3), 0)] * 9 + [(pytest.approx(5e-4), 1), (pytest.approx(5e-4), 0)]
