"""The train step replayed as one CUDA graph against the eager step, on the card.

Every test needs a CUDA device and skips without one (a CUDA graph has no
CPU mode; ``tests/test_torch_train_graph.py`` holds the choice between the
two paths on the CPU). The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_train_graph_cuda.py

Tiny widths (``parallel/dryrun.py``'s; one case at the SVQA configuration's
two units and 20 clips), kernels on, fp32 with TF32 off, one seed for both
paths. The eager step is ``forward_backward`` then
``apply_gradients``, what ``train_step`` runs when no graph can take the
step. Over 12 steps at one step an epoch (the learning rate halves at
update 10): the dropout generator's state equal, the losses within 1e-6
relative, the parameters' change by the benchmark's train limit (the
median leaf's gap within 5e-6), one capture, 11 replays and one eager step
counted; both sides run Adam's fused kernel from the second step, so that
bf16's rounding cannot amplify a difference of Adam's kernels. A step's metrics stay as they were after the next
replay; after ``adam.load_state_dict`` the next step captures again and
still agrees with the eager step; the kernels' launch counters grow by one
step's launches a replay, kernel 7's and kernel 8's by one each and kernel
9's by three; kernel 7 replayed in the graph gives the losses of the
library's projection within 1e-5, kernel 8 those of the library's weight
gradient, and kernel 9 those of the library's recurrent weight gradient.
"""

import copy

import numpy as np
import pytest
import torch

from dualvgr_tpu_torch import build_model, train_lib
from dualvgr_tpu_torch.ops import launch_counts
from dualvgr_tpu_torch.parallel.dryrun import TINY, tiny_batches
from dualvgr_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

ALPHA, BETA = 1.0, 1e-8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trace.disable()
    trace.spans(), trace.counters()
    yield torch.device("cuda")
    trace.disable()
    trace.spans(), trace.counters()


def _state(compute_dtype="float32", graph_module="GAT", depth=None):
    model = build_model(device="cuda", seed=0, use_kernels=True, compute_dtype=compute_dtype,
                        graph_module=graph_module, **dict(TINY, **(depth or {})))
    return train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 1), seed=3)


def _batches(n, seed=5, depth=None):
    """``n`` device batches, every third with 3 of its 8 rows padded."""
    out = []
    for i in range(n):
        b = tiny_batches(1, seed=seed + i, pad=3 if i % 3 == 2 else 0, dims=depth)[0]
        out.append(tuple(torch.as_tensor(a, device="cuda") for a in b))
    return out


def _eager(state, batch):
    """The eager step, with Adam's kernel the graph's from the second step
    (``train_step`` turns Adam to it before capturing), so that both sides
    do the same arithmetic."""
    if state.adam.state:
        train_lib._make_capturable(state.adam, state.generator.device)
    metrics = train_lib.forward_backward(state, batch, alpha=ALPHA, beta=BETA)
    train_lib.apply_gradients(state)
    return metrics


def _graphed(state, batch):
    return train_lib.train_step(state, batch, alpha=ALPHA, beta=BETA)


def _change_median_gap(got, want, start):
    """The benchmark's ``change_median_gap``: the median leaf's gap between
    two states' changes from ``start``, over the larger of the eager
    change and the median one."""
    norm = lambda model: [float((p.detach() - p0).norm()) for p, p0 in zip(model.parameters(), start)]
    g, w = norm(got), norm(want)
    median = float(np.median(w))
    return float(np.median([abs(a - b) / max(b, median) for a, b in zip(g, w)]))


# the SVQA configuration's depth and graph: two stacked units, 20 clips
SVQA_DEPTH = {"unit_layers": 2, "num_of_nodes": 20}


@pytest.mark.parametrize("compute_dtype, graph_module, depth", [
    pytest.param("float32", "GAT", None, id="float32-GAT"),
    pytest.param("bfloat16", "GAT", None, id="bfloat16-GAT"),
    pytest.param("float32", "GCN", None, id="float32-GCN"),
    pytest.param("float32", "GAT", SVQA_DEPTH, id="float32-GAT-U2-N20"),
])
def test_twelve_graphed_steps_match_twelve_eager_ones(cuda, compute_dtype, graph_module, depth):
    graphed, eager = _state(compute_dtype, graph_module, depth), _state(compute_dtype, graph_module, depth)
    start = [p.detach().clone() for p in eager.model.parameters()]
    batches = _batches(12, depth=depth)
    trace.enable()
    got = [float(_graphed(graphed, b)["loss"]) for b in batches]
    trace.disable()
    want = [float(_eager(eager, b)["loss"]) for b in batches]
    counters = trace.counters()
    assert (counters.get("train.graph_captures"), counters.get("train.graph_replays"),
            counters.get("train.eager_steps")) == (1, 11, 1)
    # the host runs the unit cycles of the eager step and of the capture alone
    assert counters.get("model.unit_cycles") == 2 * graphed.model.visual_input_unit.unit_layers
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert _change_median_gap(graphed.model, eager.model, start) <= 5e-6
    for a, b in zip(graphed.model.buffers(), eager.model.buffers()):  # the batch norm's statistics
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (graphed.step, graphed.updates) == (eager.step, eager.updates) == (12, 12)
    assert float(graphed.adam.param_groups[0]["lr"]) == pytest.approx(5e-4)


def test_a_steps_metrics_outlive_the_next_replay(cuda):
    state = _state()
    kept, returned = [], []
    for b in _batches(4):
        m = _graphed(state, b)
        returned.append(m)
        kept.append({k: v.clone() for k, v in m.items()})
    for m, k in zip(returned, kept):
        assert all(torch.equal(m[name], k[name]) for name in k)
    assert len({m["loss"].data_ptr() for m in returned}) == 4
    assert [int(m["count"]) for m in returned] == [8, 8, 5, 8]


def test_a_step_after_adam_load_state_dict_captures_again(cuda):
    """As the benchmark's ``unchanged`` fault and a restore do: Adam's state
    rolled back to a deep copy (new tensors) after step 4; step 5 cannot
    replay the graph that holds the old ones."""
    graphed, eager = _state(), _state()
    batches = _batches(6)
    trace.enable()
    for i, b in enumerate(batches):
        if i == 3:
            saved = [copy.deepcopy(s.adam.state_dict()) for s in (graphed, eager)]
        if i == 4:
            for s, sd in zip((graphed, eager), saved):
                s.adam.load_state_dict(sd)
        got, want = float(_graphed(graphed, b)["loss"]), float(_eager(eager, b)["loss"])
        assert got == pytest.approx(want, rel=1e-6), i
    trace.disable()
    counters = trace.counters()
    assert (counters["train.graph_captures"], counters["train.graph_replays"], counters["train.eager_steps"]) == \
        (2, 5, 1)
    assert len(graphed.graphs) == 1
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())


def test_a_replay_counts_the_launches_it_holds(cuda):
    graphed, eager = _state(), _state()
    batches = _batches(4)
    counts = []
    for b in batches:
        before = launch_counts()
        _graphed(graphed, b)
        counts.append(tuple(a - c for a, c in zip(launch_counts(), before)))
    before = launch_counts()
    _eager(eager, batches[0])
    one_step = tuple(a - c for a, c in zip(launch_counts(), before))
    assert one_step[2] > 0 and one_step[3] > 0  # kernels 3 and 4
    assert one_step[7] == 1  # kernel 7: both directions of the appearance projection in one launch
    assert one_step[8] == 1  # kernel 8: both directions of its weight gradient in one launch
    assert one_step[9] == 3  # kernel 9: dW_hh of the appearance and both question BiLSTMs, a launch each
    assert counts == [one_step] * 4


def test_kernel_7_in_the_captured_step_matches_the_library_projection(cuda, monkeypatch):
    """Kernel 7 captured and replayed in the graph: 6 graphed steps against
    6 eager ones whose appearance projection is the two baddbmm products
    (fp32, TF32 off), the losses within 1e-5 relative; the capture and the
    eager first step count their rows in ``proj.tc_f32_rows``, the replays
    nothing."""
    from dualvgr_tpu_torch.ops import lstm_train, proj_kernel

    graphed, eager = _state(), _state()
    batches = _batches(6)
    trace.enable()
    got = [float(_graphed(graphed, b)["loss"]) for b in batches]
    trace.disable()
    counters = trace.counters()
    b, c, f, _ = batches[0][0].shape
    assert counters["proj.tc_f32_rows"] == 2 * b * c * f
    assert (counters["train.graph_captures"], counters["train.graph_replays"]) == (1, 5)
    monkeypatch.setattr(lstm_train, "input_proj_f32", proj_kernel.input_proj_f32_reference)
    want = [float(_eager(eager, b)["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kernel_8_in_the_captured_step_matches_the_library_weight_gradient(cuda, monkeypatch):
    """Kernel 8 captured and replayed in the graph: 6 graphed steps against
    6 eager ones whose dW_ih is the two library products after their
    transposing copies (fp32, TF32 off), the losses within 1e-5 relative;
    the capture and the eager first step count their rows in
    ``proj.tc_f32_wgrad_rows``, as many as kernel 7's ``proj.tc_f32_rows``,
    the replays nothing."""
    from dualvgr_tpu_torch.ops import lstm_train, proj_kernel

    graphed, eager = _state(), _state()
    batches = _batches(6)
    trace.enable()
    got = [float(_graphed(graphed, b)["loss"]) for b in batches]
    trace.disable()
    counters = trace.counters()
    b, c, f, _ = batches[0][0].shape
    assert counters["proj.tc_f32_wgrad_rows"] == 2 * b * c * f == counters["proj.tc_f32_rows"]
    assert (counters["train.graph_captures"], counters["train.graph_replays"]) == (1, 5)
    monkeypatch.setattr(lstm_train, "input_proj_f32_wgrad", proj_kernel.input_proj_f32_wgrad_reference)
    want = [float(_eager(eager, b)["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_kernel_9_in_the_captured_step_matches_the_library_recurrent_weight_gradient(cuda, monkeypatch):
    """Kernel 9 captured and replayed in the graph: 6 graphed steps against
    6 eager ones whose dW_hh is the two library products of each BiLSTM
    (fp32, TF32 off), the losses within 1e-5 relative; the capture and the
    eager first step count their rows in ``lstm.tc_f32_whh_rows``: the
    appearance BiLSTM's R*T and both question BiLSTMs', the replays
    nothing."""
    from dualvgr_tpu_torch.ops import lstm_train, whh_grad_kernel

    graphed, eager = _state(), _state()
    batches = _batches(6)
    trace.enable()
    got = [float(_graphed(graphed, b)["loss"]) for b in batches]
    trace.disable()
    counters = trace.counters()
    b, c, f, _ = batches[0][0].shape
    tokens = batches[0][2].shape[1]
    assert counters["lstm.tc_f32_whh_rows"] == 2 * (b * c * f + 2 * b * tokens)
    assert (counters["train.graph_captures"], counters["train.graph_replays"]) == (1, 5)
    monkeypatch.setattr(lstm_train, "whh_grad_f32", whh_grad_kernel.whh_grad_f32_reference)
    want = [float(_eager(eager, b)["loss"]) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
