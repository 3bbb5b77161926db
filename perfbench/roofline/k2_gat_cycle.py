"""Kernel 2, the fused graph cycle of the eval forward (``csrc/gat_cycle.cu``):
one launch a stream (appearance, motion) a step. Per launch on B rows of
N clips, D wide: the common and specific GATs' W products and value
reads, the pairwise logits and the SFGCN projections; the clip features,
the three D x D weights, the small vectors and one score a clip read once,
the output, common and specific features written once. A frozen copy of
the count the program's ``chip_smoke.py`` states."""

import re

PATTERN = re.compile(r"gat_cycle_kernel")
HEADS = 4


def launch(b: int, n: int, d: int, heads: int = HEADS) -> tuple[float, float]:
    flops = 8.0 * b * n * d * d + 4.0 * b * n * n * d + 8.0 * b * n * d
    nbytes = 4 * (b * n * d + 3 * d * d + 4 * d + 4 * heads * (d // heads) + 2 * heads) + 4 * b * n + 4 * 3 * b * n * d
    return flops, nbytes


def launches(step: dict, model: dict) -> list:
    return [launch(step["rows"], model["num_of_nodes"], model["module_dim"])] * 2
