"""Kernel 2's launch plan, on the CPU.

``ops/gat_kernel.py::cycle_plan`` decides how one launch of the graph cycle
(``csrc/gat_cycle.cu``) spreads over the card: CTAs a cluster (each owning
whole heads, a column slice), videos a cluster, the column lanes and
passes of the products, and the shared memory per CTA; the kernel computes
its videos and columns with the formulas of ``cluster_videos`` and
``cta_columns``. The card test ``test_gat_cycle_plan_shared_memory_is_the_builds``
holds the plan's shared memory against the library's.
"""

import re

import pytest

from dualvgr_tpu_torch.models.dualvgr import kernel_dim_limits
from dualvgr_tpu_torch.ops import _build, gat_kernel
from dualvgr_tpu_torch.ops.gat_kernel import cluster_videos, cta_columns, cycle_plan

HEADS = 4  # the model's GATs (models/graph.py)
CARD = ((1, 132), (2, 66), (4, 30))  # clusters of each size an H100 keeps resident at the flagship dims


@pytest.mark.parametrize("b", [1, 5, 32, 256])
@pytest.mark.parametrize("n,d", [
    (8, 768), (16, 768), (20, 768),  # the shipped configs' clip counts at the flagship width
    (4, 64), (6, 64), (20, 200),     # the card tests' shapes
])
def test_plan_covers_every_video_and_column_once(b, n, d):
    plan = cycle_plan(b, n, d, HEADS)
    videos = [v for c in range(plan.clusters) for v in cluster_videos(plan, b, c)]
    assert sorted(videos) == list(range(b))
    assert all(len(cluster_videos(plan, b, c)) for c in range(plan.clusters))
    cols = [c for rank in range(plan.cluster) for c in cta_columns(plan, rank)]
    assert sorted(cols) == list(range(d))
    assert plan.cluster * plan.heads_per_cta == HEADS
    assert plan.cols_per_cta == plan.heads_per_cta * d // HEADS and plan.cols_per_cta % 4 == 0
    assert plan.ctas == plan.cluster * plan.clusters
    assert 1 <= plan.cluster <= 16
    sizes = [len(cluster_videos(plan, b, c)) for c in range(plan.clusters)]
    assert max(sizes) == plan.videos_per_cluster and max(sizes) - min(sizes) <= 1
    assert plan.rows_per_tile == plan.videos_per_cluster * n <= plan.padded_rows <= gat_kernel.MAX_ROWS
    lanes = gat_kernel.THREADS // plan.col_lanes
    assert plan.tile_rows in gat_kernel.TILE_ROWS and plan.padded_rows % plan.tile_rows == 0
    assert plan.padded_rows - plan.rows_per_tile < plan.tile_rows
    assert plan.col_lanes <= gat_kernel.MAX_COL_LANES and plan.padded_rows // plan.tile_rows <= lanes
    # the K split's groups fit the row lanes, each with 4 k or more of a chunk
    assert plan.k_split * plan.padded_rows // plan.tile_rows <= lanes and 4 * plan.k_split <= gat_kernel.K_CHUNK
    assert 0 < plan.smem_bytes <= gat_kernel.SMEM_LIMIT
    assert plan.smem_bytes == gat_kernel.smem_bytes(n, d, HEADS, plan.cluster, plan.videos_per_cluster,
                                                    plan.col_lanes, plan.tile_rows)


def test_flagship_and_serving_plans():
    """Batch 256 at N = 16 takes clusters of 4 CTAs, a head each, in one
    wave of 33 clusters on the default count (one CTA an SM); with the
    counts an H100 reports, clusters of 2 in one wave. The serving batch of
    32 puts at least 100 CTAs on the card in one wave."""
    flagship = cycle_plan(256, 16, 768, HEADS)
    assert (flagship.cluster, flagship.cols_per_cta, flagship.clusters, flagship.videos_per_cluster) == (4, 192, 33, 8)
    assert (flagship.ctas, flagship.waves, flagship.tile_rows, flagship.k_split) == (132, 1.0, 8, 1)
    # the weight ring, the A ring, the GAT's rows, the logits, the attention, the scores
    assert flagship.smem_bytes == 4 * (2 * 32 * 192 + 2 * 128 * 36 + 128 * 196 + 2 * 128 + 8 * 16 * 16 + 3 * 128)
    assert flagship.smem_bytes == 197_120
    # an H100 keeps 30 clusters of 4 resident: four-CTA clusters take two
    # rounds of tiles of 4 or 5 videos (all 16 row lanes busy) ...
    fours = cycle_plan(256, 16, 768, HEADS, ((4, 30),), cluster=4)
    assert (fours.clusters, fours.videos_per_cluster, fours.waves) == (60, 5, 2.0)
    assert (fours.tile_rows, fours.padded_rows, fours.k_split) == (5, 80, 1)
    # ... so clusters of 2 (2 heads a CTA, two column passes) fill the 132 SMs in one
    on_card = cycle_plan(256, 16, 768, HEADS, CARD)
    assert (on_card.cluster, on_card.clusters, on_card.videos_per_cluster, on_card.col_passes) == (2, 66, 4, 2)
    assert (on_card.ctas, on_card.waves) == (132, 1.0)
    for resident in (None, CARD):
        serving = cycle_plan(32, 16, 768, HEADS, resident)
        assert serving.ctas >= 100 and serving.waves <= 1 and serving.k_split >= 2


@pytest.mark.parametrize("heads,d", [(1, 768), (2, 768), (3, 768), (64, 768), (768, 768), (4, 764), (8, 200)])
def test_plan_takes_any_heads_that_divide_the_width(heads, d):
    """The wrapper takes any H with H * hd == D, as the earlier kernel did:
    a CTA holds enough whole heads for a column slice that is a multiple of
    4, and wide slices are computed in several column passes."""
    plan = cycle_plan(7, 20, d, heads)
    assert sorted(c for r in range(plan.cluster) for c in cta_columns(plan, r)) == list(range(d))
    assert plan.smem_bytes <= gat_kernel.SMEM_LIMIT


def source_constants():
    """The ``constexpr int`` constants of ``csrc/gat_cycle.cu``, evaluated in
    order (sums, products and integer divisions of earlier ones)."""
    values = {}
    for decl in re.findall(r"constexpr int ([^;(]+);", (_build.CSRC / "gat_cycle.cu").read_text()):
        for item in decl.split(","):
            key, expr = (part.strip() for part in item.split("="))
            values[key] = eval(expr.replace("/", "//"), {}, dict(values))  # noqa: S307
    return values


def test_plan_mirrors_the_kernel_build():
    k = source_constants()
    assert (k["kThreads"], k["kTN"], k["kKC"], k["kAStride"], k["kStages"]) == (
        gat_kernel.THREADS, gat_kernel.TILE_COLS, gat_kernel.K_CHUNK, gat_kernel.A_STRIDE, gat_kernel.STAGES)
    assert tuple(range(k["kMinTM"], k["kMaxTM"] + 1)) == gat_kernel.TILE_ROWS
    # one build for each rows-a-thread the plan may pick
    text = (_build.CSRC / "gat_cycle.cu").read_text()
    assert all(f"gat_cycle_kernel<{tm}>" in text for tm in gat_kernel.TILE_ROWS)
    assert (k["kMaxRows"], k["kMaxColLanes"], k["kMaxCluster"], k["kSmemLimit"]) == (
        gat_kernel.MAX_ROWS, gat_kernel.MAX_COL_LANES, gat_kernel.MAX_CLUSTER, gat_kernel.SMEM_LIMIT)
    assert (k["kMaxNodes"], k["kMaxDim"]) == (gat_kernel.MAX_NODES, gat_kernel.MAX_DIM)


@pytest.mark.parametrize("n", [1, 8, 16, 20, 21, 24])
def test_plan_agrees_with_kernel_dim_limits(n):
    """``build_model`` refuses, through ``kernel_dim_limits``, exactly the
    dims the plan refuses."""
    for d in (4, 64, 200, 764, 766, 768, 770, 772, 1024):
        refused = any("graph-cycle" in msg for msg in kernel_dim_limits(module_dim=d, num_of_nodes=n))
        try:
            cycle_plan(256, n, d, HEADS)
            planned = True
        except ValueError:
            planned = False
        assert planned != refused, (n, d)


@pytest.mark.parametrize("b,n,d,heads", [(0, 16, 768, 4), (8, 21, 768, 4), (8, 16, 772, 4), (8, 16, 770, 4),
                                         (8, 16, 768, 5)])
def test_plan_refuses_what_the_kernel_does_not_take(b, n, d, heads):
    with pytest.raises(ValueError):
        cycle_plan(b, n, d, heads)
