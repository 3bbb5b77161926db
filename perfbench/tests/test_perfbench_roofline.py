"""The work counts against hand counts, against the bounds the repository
records for the flagship shapes (batch 256, 16 clips x 16 frames,
module_dim 768, questions of 14 tokens on average), against the products
the port's train step takes, and each kernel's name pattern against the
port's CUDA sources."""

import re

import pytest
import torch

from perfbench.lib import common
from perfbench.lib.model_flops import dims_of, forward_flops, train_flops
from perfbench.lib.peaks import PEAK_BYTES, PEAK_FLOPS, bound_s
from perfbench.lib.roofline import share
from perfbench.lib.trace import TraceData
from perfbench.roofline import (
    k1_recurrence, k2_gat_cycle, k3_train_fwd, k4_train_bwd, k7_input_proj_f32, k8_wgrad_f32, lstm_work,
)

FLAGSHIP = common.config("msrvtt-qa")["model"]
STEP = {"rows": 256, "q_pad": 24, "qlen_sum": 256 * 14, "valid": 256}
TRAIN_CONFIGS = ("msrvtt-qa", "msvd-qa", "svqa")


def bounds_ms(kernel):
    return [1e3 * bound_s(f, b) for f, b in kernel.launches(STEP, FLAGSHIP)]


def test_recurrence_by_hand():
    # one direction's step is an (H) @ (H, 4H) product: 2 * H * 4H flops, two
    # directions, at every step of a row but its first (the zero initial state)
    t, r, h = 16, 4096, 384
    flops, nbytes = lstm_work.recurrence(t, r, h, t * r, False, False)
    assert flops == 2 * 2 * (t - 1) * r * h * 4 * h
    # gates read once (fp32, both directions), both W_hh, the final states written
    assert nbytes == 4 * 2 * t * r * 4 * h + 4 * 2 * h * 4 * h + 4 * r * 2 * h


def test_train_backward_by_hand():
    # kernel 4: one product a step (dgates @ W_hh^T), as the forward's
    t, r, h = 16, 4096, 384
    flops, nbytes = lstm_work.train_backward(t, r, h, t * r, False, False)
    assert flops == lstm_work.train_forward(t, r, h, t * r, False, False)[0]
    # read: the activations (2, T, R, 4H), c_{t-1} (T, R, 2H), both W_hh, dfinal (R, 2H);
    # written: both directions' dgates (T, R, 4H)
    assert nbytes == 4 * (2 * t * r * 4 * h + t * r * 2 * h + 2 * h * 4 * h + r * 2 * h + 2 * t * r * 4 * h)


def test_kernel_bounds_at_the_flagship():
    app, q1, q2 = bounds_ms(k1_recurrence)[::-1]
    assert app == pytest.approx(0.8785, abs=5e-4) and q1 == pytest.approx(0.0476, abs=5e-4) and q2 == q1
    k3 = bounds_ms(k3_train_fwd)
    assert k3[2] == pytest.approx(0.8785, abs=5e-4) and k3[0] == pytest.approx(0.0542, abs=5e-4)
    k4 = bounds_ms(k4_train_bwd)
    assert k4[2] == pytest.approx(0.8785, abs=5e-4) and k4[0] == pytest.approx(0.0580, abs=5e-4)
    assert bounds_ms(k2_gat_cycle) == [pytest.approx(0.1185, abs=5e-4)] * 2
    assert bounds_ms(k7_input_proj_f32) == bounds_ms(k8_wgrad_f32) == [pytest.approx(4.9978, abs=5e-4)]


def test_gat_cycle_by_hand():
    b, n, d = 256, 16, 768
    flops, nbytes = k2_gat_cycle.launch(b, n, d)
    # W products of the two GATs and the two SFGCN projections (4 x 2 B N D D),
    # attention over N^2 (2 x 2 B N N D), the small per-node work (8 B N D)
    assert flops == 8 * b * n * d * d + 4 * b * n * n * d + 8 * b * n * d
    assert nbytes > 4 * 4 * b * n * d  # features in, three feature tensors out


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
@pytest.mark.parametrize("kernel", [k7_input_proj_f32, k8_wgrad_f32], ids=["k7", "k8"])
def test_projection_work_against_chip_smoke(kernel, config):
    # chip_smoke.py's phase_proj_f32 and phase_wgrad_f32 at the train cells'
    # rows: product = 2 R T D 2G, bound by its three TF32 products at 495 TFLOP/s
    m = common.config(config)["model"]
    r, t, d, g = 256 * m["num_of_nodes"], m["frames_per_clip"], m["vision_dim"], 4 * m["module_dim"] // 2
    product = 2 * r * t * d * 2 * g
    if kernel is k7_input_proj_f32:
        nbytes = r * t * d * 4 + 2 * (2 * g * d * 4) + 2 * g * 4 + 2 * t * r * g * 4  # x, W_hi, W_lo, bias, out
    else:
        nbytes = r * t * d * 4 + 2 * t * r * g * 4 + 2 * g * d * 4  # x, the dgates, dW
    assert kernel.launches({"rows": 256}, m) == [(product, nbytes)]
    assert bound_s(product, nbytes) == pytest.approx(3 * product / 495e12)
    # PERF.md's bounds of kernels 7 and 8: 5.00, 2.50 and 6.25 ms
    assert 1e3 * bound_s(product, nbytes) == pytest.approx({"msrvtt-qa": 5.0, "msvd-qa": 2.5, "svqa": 6.25}[config],
                                                           abs=5e-3)


def _kernel_names() -> dict:
    """{kernel name: source} of every ``__global__`` function in the sources
    the port builds and the headers they include."""
    from dualvgr_tpu_torch.ops import _build

    names = {}
    for path in [_build.CSRC / s for s in _build.SOURCES] + sorted(_build.CSRC.glob("*.cuh")):
        for name in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", path.read_text()):
            names[name] = path.name
    return names


@pytest.mark.parametrize("kernel, own", [
    (k2_gat_cycle, {"gat_cycle_kernel"}),
    (k4_train_bwd, {"bwd_kernel"}),
    (k7_input_proj_f32, {"input_proj_f32_kernel", "tf32_split_kernel"}),
    (k8_wgrad_f32, {"wgrad_f32_kernel", "x_split_kernel"}),
], ids=["k2", "k4", "k7", "k8"])
def test_a_pattern_matches_its_own_kernels_only(kernel, own):
    names = _kernel_names()
    assert own <= set(names)
    # as the profiler names them: the anonymous namespace, then the arguments
    matched = {n for n in names if kernel.PATTERN.search(f"(anonymous namespace)::{n}(float const*, int)")}
    assert matched == own


@pytest.mark.parametrize("config, per_question", [("msrvtt-qa", 9.644e9), ("svqa", 13.039e9), ("msvd-qa", 5.166e9)])
def test_model_flops_per_question(config, per_question):
    assert train_flops(**dims_of(common.config(config))) == pytest.approx(per_question, rel=1e-3)
    assert forward_flops(**dims_of(common.config("msvd-qa"))) == pytest.approx(2.28e9, rel=3e-3)


TINY = dict(vision_dim=64, module_dim=16, word_dim=8, num_answers=50, num_of_nodes=4, graph_layers=1)
TINY_FRAMES, TINY_TOKENS, TINY_BATCH = 3, 6, 2


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel_path"])
@pytest.mark.parametrize("unit_layers", [1, 2])
def test_train_flops_are_the_products_the_train_step_takes(use_kernels, unit_layers):
    """The port's train step at a tiny size on the CPU, its forward and its
    backward counted by torch's FlopCounterMode: the forward is
    ``forward_flops`` and the two together ``train_flops``, so the products
    whose input gradients autograd does not take are the ones
    ``untaken_input_grad_flops`` lists."""
    from torch.utils.flop_counter import FlopCounterMode

    from dualvgr_tpu_torch.models.dualvgr import build_model

    model = build_model(device="cpu", use_kernels=use_kernels, question_vocab_size=40, unit_layers=unit_layers,
                        **TINY).train()
    gen = torch.Generator().manual_seed(0)
    b, c, v = TINY_BATCH, TINY["num_of_nodes"], TINY["vision_dim"]
    app, mot = torch.randn(b, c, TINY_FRAMES, v, generator=gen), torch.randn(b, c, v, generator=gen)
    question = torch.randint(1, 40, (b, TINY_TOKENS), generator=gen)
    qlen = torch.full((b,), TINY_TOKENS)
    # kernels 7 and 8 are custom ops, opaque to the counter: each one fp32
    # product over both directions
    ops = torch.ops.dualvgr_torch
    mapping = {
        ops.input_proj_f32: lambda x, w_f, b_f, w_b, b_b, out_shape=None: 2 * x[0] * x[1] * x[2] * (w_f[0] + w_b[0]),
        ops.input_proj_f32_wgrad: lambda x, dxf, dxb, out_shape=None: 2 * x[0] * x[1] * x[2] * (dxf[-1] + dxb[-1]),
    }
    with FlopCounterMode(display=False, custom_mapping=mapping) as fwd:
        out = model(app, mot, question, qlen, torch.ones(b), generator=torch.Generator().manual_seed(1))
    # a loss without products, so that the backward counts the model's alone
    loss = sum((o * torch.randn(o.shape, generator=gen)).sum() for o in out
               if isinstance(o, torch.Tensor) and o.requires_grad)
    with FlopCounterMode(display=False, custom_mapping=mapping) as bwd:
        loss.backward()
    assert all(p.grad is not None for p in model.parameters())

    dims = dict(TINY, frames_per_clip=TINY_FRAMES, q_len=TINY_TOKENS, unit_layers=unit_layers)
    h = TINY["module_dim"] // 2
    # the plain version of kernel 4 (ops/lstm_train_kernel.py) takes the first
    # step's gradient too, which the kernel skips: one product a sequence and direction
    plain_kernel_4 = (4 + 2 * c) * 2 * h * 4 * h if use_kernels else 0
    assert fwd.get_total_flops() / b == forward_flops(**dims)
    assert (fwd.get_total_flops() + bwd.get_total_flops()) / b == train_flops(**dims) + plain_kernel_4
    assert train_flops(**dims) < 0.9 * 3 * forward_flops(**dims)


def test_share_is_the_bound_over_the_kernel_time():
    launches = k2_gat_cycle.launches(STEP, FLAGSHIP)
    least = sum(bound_s(f, b) for f, b in launches)
    trace = TraceData("eval", {"model": FLAGSHIP}, {}, kernels=[("void gat_cycle_kernel<4>(Params)", 0.0, 2 * least),
                                                               ("other", 0.0, 1.0)], steps=[STEP])
    assert share(trace, k2_gat_cycle) == pytest.approx(50.0)
    assert share(trace, k1_recurrence) is None  # no launch: no reading, never 0


def test_projection_shares_count_the_split_passes():
    kernels = [("(anonymous namespace)::input_proj_f32_kernel(CUtensorMap_st)", 0.0, 6e-3),
               ("(anonymous namespace)::tf32_split_kernel(float4 const*)", 0.0, 1e-3),
               ("(anonymous namespace)::wgrad_f32_kernel(CUtensorMap_st)", 0.0, 9e-3),
               ("(anonymous namespace)::x_split_kernel(float const*)", 0.0, 1e-3),
               ("(anonymous namespace)::input_proj_kernel(CUtensorMap_st)", 0.0, 1.0)]
    trace = TraceData("train", {"model": FLAGSHIP}, {}, kernels=kernels, steps=[STEP])
    least = bound_s(*k7_input_proj_f32.launches(STEP, FLAGSHIP)[0])
    assert share(trace, k7_input_proj_f32) == pytest.approx(100 * least / 7e-3)
    assert share(trace, k8_wgrad_f32) == pytest.approx(100 * least / 10e-3)


def test_peaks():
    # one fp32 peak: 3xTF32 on the tensor cores, the card's fp32-accurate matmul rate
    assert PEAK_FLOPS["float32"] == 495e12 / 3 and PEAK_FLOPS["bfloat16"] == 989e12 and PEAK_BYTES == 3.35e12
    assert bound_s(165e12, 0) == pytest.approx(1.0) and bound_s(0, 3.35e12) == 1.0
