"""Kernel 4's launch plan and the build-time check of the kernels' dims, on the CPU.

``ops/lstm_kernel.py::backward_plan`` decides how one launch of the BiLSTM
backward (``csrc/bilstm_train_bwd.cu``) spreads over the card: kernel 3's
cluster size, units per CTA and 16-row tiles, and the (direction, row
tile) items the resident clusters walk; the kernel computes its units and
items with the formulas of ``cta_units`` and ``cluster_items``.
``models/dualvgr.py::kernel_dim_limits`` names each limit of the kernels
that a model's dims break, and ``build_model`` raises with them before any
forward on the card; on the CPU the wrappers run their plain versions and
any dims build.
"""

import glob
import os
import re

import pytest

from dualvgr_tpu_torch import build_model, config
from dualvgr_tpu_torch.models.dualvgr import kernel_dim_limits
from dualvgr_tpu_torch.ops import _build, lstm_kernel
from dualvgr_tpu_torch.ops.lstm_kernel import backward_plan, cluster_items, cta_units

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


@pytest.mark.parametrize("rows", [1, 19, 256, 4096])
@pytest.mark.parametrize("hidden", [16, 100, 384])
def test_backward_plan_owns_every_unit_and_walks_every_tile_once(hidden, rows):
    for active in (6, 7, 8):
        plan = backward_plan(rows, hidden, active)
        assert (plan.cluster, plan.units) == lstm_kernel.cluster_shape(hidden)
        assert plan.rows_per_tile == lstm_kernel.ROWS_PER_TILE
        units = [u for r in range(plan.cluster) for u in cta_units(plan, hidden, r)]
        assert sorted(units) == list(range(hidden))
        assert plan.tiles * plan.rows_per_tile >= rows > (plan.tiles - 1) * plan.rows_per_tile
        assert 1 <= plan.clusters <= min(active, 2 * plan.tiles)
        walked = [item for c in range(plan.clusters) for item in cluster_items(plan, c)]
        assert sorted(walked) == [(d, t) for d in (0, 1) for t in range(plan.tiles)]
        loads = [len(cluster_items(plan, c)) for c in range(plan.clusters)]
        assert max(loads) == plan.tiles_per_cluster and max(loads) - min(loads) <= 1
        assert 0 < plan.smem_bytes <= lstm_kernel.SMEM_LIMIT


def source_constants():
    """The ``constexpr int`` constants of ``csrc/bilstm_cluster.cuh`` and
    then ``csrc/bilstm_train_bwd.cu``, evaluated in order (sums, products
    and integer divisions of earlier ones)."""
    values = {}
    for name in ("bilstm_cluster.cuh", "bilstm_train_bwd.cu"):
        text = (_build.CSRC / name).read_text()
        for decl in re.findall(r"constexpr int ([^;(]+);", text):
            for item in decl.split(","):
                key, expr = (part.strip() for part in item.split("="))
                values[key] = eval(expr.replace("/", "//"), {}, dict(values))  # noqa: S307
    return values


def test_backward_plan_mirrors_the_kernel_build():
    """Kernel 4 builds on the forward's constants, which
    ``test_plan_mirrors_the_kernel_build`` holds against the header; its
    own fit them: the dh product's lanes cover every row and hidden unit,
    and a cluster has at most kMaxSenders CTAs. Its shared memory at every
    H it takes fits the card; the flagship's is the sum the source
    documents."""
    k = source_constants()
    assert (k["kRows"], k["kGateCols"], k["kMaxHidden"]) == (
        lstm_kernel.ROWS_PER_TILE, lstm_kernel.GATE_COLS, lstm_kernel.MAX_HIDDEN)
    assert k["kDhRowGroups"] * k["kDhRows"] == k["kRows"]
    assert k["kDhCols"] * k["kDhLanes"] >= lstm_kernel.MAX_HIDDEN
    assert k["kMaxSenders"] == max(lstm_kernel.CLUSTER_SIZES)
    for hidden in range(4, lstm_kernel.MAX_HIDDEN + 1, 4):
        assert backward_plan(8, hidden, 7).smem_bytes <= lstm_kernel.SMEM_LIMIT, hidden
    flagship = backward_plan(4096, 384, 7)
    # the mbarriers, the W slice, the dgates tile, the receive buffer
    assert flagship.smem_bytes == 16 + 148_992 + 6_144 + 24_576 == 179_728
    assert (flagship.cluster, flagship.units, flagship.tiles, flagship.tiles_per_cluster) == (16, 24, 256, 74)


@pytest.mark.parametrize("hidden", [0, 6, 388, 512])
def test_backward_plan_refuses_what_the_kernel_does_not_take(hidden):
    with pytest.raises(ValueError, match="hidden"):
        backward_plan(16, hidden, 7)


@pytest.mark.parametrize("dims,names", [
    (dict(module_dim=1024), ["BiLSTM", "graph-cycle"]),
    (dict(num_of_nodes=24), ["num_of_nodes"]),
    (dict(module_dim=770), ["BiLSTM", "graph-cycle"]),
    (dict(module_dim=1024, num_of_nodes=24, graph_layers=2), ["BiLSTM"]),
    (dict(vision_dim=2044, compute_dtype="bfloat16"), ["projection"]),
    (dict(vision_dim=2044), []),
    (dict(vision_dim=2046), ["fp32 projection"]),
])
def test_kernel_dim_limits_names_each_broken_limit(dims, names):
    got = kernel_dim_limits(**dims)
    assert len(got) == len(names), got
    for msg, name in zip(got, names):
        assert name in msg


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_shipped_configs_break_no_kernel_limit(path):
    cfg = config.cfg_from_file(path)
    dims = dict(vision_dim=cfg.train.vision_dim, module_dim=cfg.train.module_dim,
                num_of_nodes=cfg.train.num_of_nodes, graph_layers=cfg.graph_layers)
    for dtype in ("float32", "bfloat16"):
        assert kernel_dim_limits(compute_dtype=dtype, **dims) == []


def test_cpu_models_take_any_dims():
    """On the CPU the kernels' wrappers run their plain versions: a model
    whose dims the kernels cannot take builds with kernels on."""
    model = build_model(device="cpu", vision_dim=12, module_dim=1024, word_dim=8, question_vocab_size=10,
                        num_answers=5, num_of_nodes=24, graph_layers=1, unit_layers=1)
    assert model.use_kernels and kernel_dim_limits(module_dim=1024, num_of_nodes=24)
