"""The work counts against hand counts and against the bounds the
repository records for the flagship shapes (batch 256, 16 clips x 16
frames, module_dim 768, questions of 14 tokens on average)."""

import pytest

from perfbench.lib import common
from perfbench.lib.model_flops import dims_of, forward_flops, train_flops
from perfbench.lib.peaks import PEAK_BYTES, PEAK_FLOPS, bound_s
from perfbench.lib.roofline import share
from perfbench.lib.trace import TraceData
from perfbench.roofline import k1_recurrence, k2_gat_cycle, k3_train_fwd, k4_train_bwd, lstm_work

FLAGSHIP = common.config("msrvtt-qa")["model"]
STEP = {"rows": 256, "q_pad": 24, "qlen_sum": 256 * 14, "valid": 256}


def bounds_ms(kernel):
    return [1e3 * bound_s(f, b) for f, b in kernel.launches(STEP, FLAGSHIP)]


def test_recurrence_by_hand():
    # one direction's step is an (H) @ (H, 4H) product: 2 * H * 4H flops; two directions
    t, r, h = 16, 4096, 384
    flops, nbytes = lstm_work.recurrence(t, r, h, t * r, False, False)
    assert flops == 2 * 2 * t * r * h * 4 * h
    # gates read once (fp32, both directions), both W_hh, the final states written
    assert nbytes == 4 * 2 * t * r * 4 * h + 4 * 2 * h * 4 * h + 4 * r * 2 * h


def test_kernel_bounds_at_the_flagship():
    app, q1, q2 = bounds_ms(k1_recurrence)[::-1]
    assert app == pytest.approx(2.31, abs=0.005) and q1 == pytest.approx(0.12, abs=0.01) and q2 == q1
    k3 = bounds_ms(k3_train_fwd)
    assert k3[2] == pytest.approx(2.31, abs=0.005) and k3[0] == pytest.approx(0.13, abs=0.01)
    k4 = bounds_ms(k4_train_bwd)
    assert k4[2] == pytest.approx(4.62, abs=0.005) and k4[0] == pytest.approx(0.26, abs=0.01)
    assert bounds_ms(k2_gat_cycle) == [pytest.approx(0.29, abs=0.005)] * 2


def test_gat_cycle_by_hand():
    b, n, d = 256, 16, 768
    flops, nbytes = k2_gat_cycle.launch(b, n, d)
    # W products of the two GATs and the two SFGCN projections (4 x 2 B N D D),
    # attention over N^2 (2 x 2 B N N D), the small per-node work (8 B N D)
    assert flops == 8 * b * n * d * d + 4 * b * n * n * d + 8 * b * n * d
    assert nbytes > 4 * 4 * b * n * d  # features in, three feature tensors out


def test_model_flops_per_question():
    assert train_flops(**dims_of(common.config("msrvtt-qa"))) == pytest.approx(12.96e9, rel=1e-3)
    assert forward_flops(**dims_of(common.config("msvd-qa"))) == pytest.approx(2.28e9, rel=3e-3)


def test_share_is_the_bound_over_the_kernel_time():
    launches = k2_gat_cycle.launches(STEP, FLAGSHIP)
    least = sum(bound_s(f, b) for f, b in launches)
    trace = TraceData("eval", {"model": FLAGSHIP}, {}, kernels=[("void gat_cycle_kernel<4>(Params)", 0.0, 2 * least),
                                                               ("other", 0.0, 1.0)], steps=[STEP])
    assert share(trace, k2_gat_cycle) == pytest.approx(50.0)
    assert share(trace, k1_recurrence) is None  # no launch: no reading, never 0


def test_peaks():
    assert PEAK_FLOPS["float32"] == 67e12 and PEAK_FLOPS["bfloat16"] == 989e12 and PEAK_BYTES == 3.35e12
    assert bound_s(67e12, 0) == 1.0 and bound_s(0, 3.35e12) == 1.0
