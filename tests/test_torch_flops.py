"""The port's analytic FLOP count (``dualvgr_tpu_torch/utils/flops.py``)
equals the JAX package's on several shapes, forward and train step."""

import pytest

from dualvgr_tpu.utils import flops as jflops
from dualvgr_tpu_torch.utils import flops as tflops

FLAGSHIP = dict(vision_dim=2048, module_dim=768, word_dim=300, num_answers=4000, num_of_nodes=16,
                frames_per_clip=16, q_len=24, unit_layers=1, graph_layers=1)


@pytest.mark.parametrize("shape", [
    FLAGSHIP,
    {**FLAGSHIP, "unit_layers": 2, "graph_layers": 2, "num_of_nodes": 8},
    {**FLAGSHIP, "num_of_nodes": 20, "num_answers": 1000},
    dict(vision_dim=256, module_dim=128, word_dim=64, num_answers=50, num_of_nodes=8, frames_per_clip=8, q_len=16,
         unit_layers=2, graph_layers=1),
    dict(vision_dim=20, module_dim=16, word_dim=10, num_answers=9, num_of_nodes=4, frames_per_clip=3, q_len=6,
         unit_layers=1, graph_layers=2),
], ids=["flagship", "deep", "svqa", "small", "tiny"])
def test_counts_equal_jax(shape):
    fwd = tflops.dualvgr_forward_flops(**shape)
    assert fwd == jflops.dualvgr_forward_flops(**shape) > 0
    assert tflops.dualvgr_train_flops(**shape) == jflops.dualvgr_train_flops(**shape) == 3.0 * fwd
