"""The launch plan of the cluster recurrence (kernels 1 and 3), on the CPU.

``ops/lstm_kernel.py::recurrence_plan`` decides how one launch spreads over
the card: the cluster size and the hidden units each CTA owns (from H), the
row tiles, and how the (direction, row tile) items fall to the clusters the
card keeps resident. The kernel (``csrc/bilstm_cluster.cuh``) computes its
units and items with the same formulas as ``cta_units`` and
``cluster_items``. Checked for every H = 4..384 in steps of 4, at row counts
from one row to the appearance encoder's 4096, and for 6, 7 and 8 resident
clusters of 16 CTAs (what a 132-SM H100 can hold, depending on how its SMs
fall into GPCs).
"""

import re

import pytest

from dualvgr_tpu_torch.ops import _build, lstm_kernel
from dualvgr_tpu_torch.ops.lstm_kernel import cluster_items, cta_units, recurrence_plan


@pytest.mark.parametrize("active", [6, 7, 8])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 256, 1100, 4096])
def test_plan_owns_every_unit_and_walks_every_tile_once(rows, active):
    for hidden in range(4, lstm_kernel.MAX_HIDDEN + 1, 4):
        plan = recurrence_plan(rows, hidden, active)
        assert plan.cluster in lstm_kernel.CLUSTER_SIZES
        assert plan.rows_per_tile == lstm_kernel.ROWS_PER_TILE
        assert 4 <= plan.units <= lstm_kernel.GATE_COLS // 4 and plan.units % 4 == 0
        owners = [r for r in range(plan.cluster) for _ in cta_units(plan, hidden, r)]
        units = [u for r in range(plan.cluster) for u in cta_units(plan, hidden, r)]
        assert sorted(units) == list(range(hidden)), hidden
        assert len(owners) == hidden
        # the smallest cluster that holds H: half of it would not
        if plan.cluster > 1:
            assert 4 * -(-hidden // (2 * plan.cluster)) > lstm_kernel.GATE_COLS // 4
        assert plan.tiles * plan.rows_per_tile >= rows > (plan.tiles - 1) * plan.rows_per_tile
        assert 1 <= plan.clusters <= min(active, 2 * plan.tiles)
        walked = [item for c in range(plan.clusters) for item in cluster_items(plan, c)]
        assert sorted(walked) == [(d, t) for d in (0, 1) for t in range(plan.tiles)], hidden
        assert max(len(cluster_items(plan, c)) for c in range(plan.clusters)) == plan.tiles_per_cluster
        # the clusters' loads differ by at most one item
        loads = [len(cluster_items(plan, c)) for c in range(plan.clusters)]
        assert max(loads) - min(loads) <= 1
        assert 0 < plan.smem_bytes <= lstm_kernel.SMEM_LIMIT
    flagship = recurrence_plan(rows, 384, active)
    assert (flagship.cluster, flagship.units, flagship.rows_per_tile) == (16, 24, 16)
    assert flagship.smem_bytes == 16 + 4 * (96 * 388 + 2 * 16 * 384 + 4 * 16 * 112 + 2 * 16 * 24)


def header_constants():
    """The ``constexpr int`` constants of ``csrc/bilstm_cluster.cuh``,
    evaluated in order (their expressions are sums, products and integer
    divisions of earlier ones)."""
    text = (_build.CSRC / "bilstm_cluster.cuh").read_text()
    values = {}
    for decl in re.findall(r"constexpr int ([^;(]+);", text):
        for item in decl.split(","):
            name, expr = (part.strip() for part in item.split("="))
            values[name] = eval(expr.replace("/", "//"), {}, dict(values))  # noqa: S307
    return values


def test_plan_mirrors_the_kernel_build():
    """The plan's build constants are the header's: rows per tile, gate
    columns, the partial sums' buffers and row stride, the largest H and
    the shared-memory limit."""
    k = header_constants()
    assert (k["kRows"], k["kGateCols"], k["kRedBuffers"], k["kRedStride"], k["kMaxHidden"], k["kSmemLimit"]) == (
        lstm_kernel.ROWS_PER_TILE, lstm_kernel.GATE_COLS, lstm_kernel.RED_BUFFERS, lstm_kernel.RED_STRIDE,
        lstm_kernel.MAX_HIDDEN, lstm_kernel.SMEM_LIMIT)


def test_plan_refuses_what_the_kernel_does_not_take():
    for hidden in (0, 6, 388):
        with pytest.raises(ValueError, match="hidden"):
            recurrence_plan(16, hidden, 7)
    with pytest.raises(ValueError, match="rows"):
        recurrence_plan(0, 384, 7)
    with pytest.raises(RuntimeError, match="resident"):
        recurrence_plan(16, 384, 0)


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A source's library is named by the source and every header of
    ``csrc/``: an edited header rebuilds the kernels that include it."""
    for f in _build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {src: _build.library_path(src) for src in _build.SOURCES}
    header = tmp_path / "bilstm_cluster.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {src: _build.library_path(src) for src in _build.SOURCES}
    assert all(after[src] != before[src] for src in _build.SOURCES)
    header.write_bytes(header.read_bytes()[: -len(b"\n// edited\n")])
    assert {src: _build.library_path(src) for src in _build.SOURCES} == before
    (tmp_path / "gat_cycle.cu").write_bytes(b"// another source\n")
    assert _build.library_path("gat_cycle.cu") != before["gat_cycle.cu"]
    assert _build.library_path("bilstm_recurrence.cu") == before["bilstm_recurrence.cu"]
