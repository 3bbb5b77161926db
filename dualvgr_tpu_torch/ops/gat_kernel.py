"""The fused DualVGR graph cycle: hand-written CUDA kernel and plain version.

``gat_cycle`` replaces the TPU kernel
``dualvgr_tpu/ops/gat_pallas.py::fused_gat_cycle`` with the same arguments:
h (B, N, D), scores (B, N, hd); for the common and the specific GAT the
head-merged kernel w (D, H*hd), its bias (H*hd,), the attention vector
a (H, 2*hd) and its bias (H,); for AttentionSFGCN proj_w (D, D),
proj_b (D,) and score_w (D, 1). It returns (out, common, spec) with
out = h + SFGCN([common, spec]).

The wrapper calls the torch custom op ``dualvgr_torch::gat_cycle``, which
``torch.export`` keeps as one node, scores' strides and all. On a CPU
tensor the op runs ``gat_cycle_reference``; on a CUDA tensor it launches
``csrc/gat_cycle.cu`` through the shared launch (``ops/launch.py``) or
raises, and counts the launch in ``gat_cycle.launches``. That source says
what bounds the kernel on the H100 and what its design does about it: the
four D x D products, fp32 FMAs on the CUDA cores, bound it by operations; a
thread-block cluster takes several videos, each CTA owns whole heads (a
column slice), the weights' k-chunks stream through shared memory and
serve every row of the tile, and the cluster sums its partial scores
through distributed shared memory. What bounds it now: the products, 82%
of a launch at B = 256, N = 16 on the H100, their FMAs at about 43% of the
fp32 rate (``bench/gat_kernel_ab.py``'s cuts). The launch plan is
``cycle_plan``, here, so the CPU tests cover it; ``card_plan`` gives it the
clusters of each size the card keeps resident (30 of 4 CTAs, 66 of 2 on an
H100: a cluster's CTAs share a GPC). ``dim_limits`` says which dims the
kernel cannot take.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from dualvgr_tpu_torch.ops.launch import OPS_NAMESPACE, call, check, dispatch, launch, refuse_autograd

MAX_NODES = 20  # kMaxNodes in the source
MAX_DIM = 768  # kMaxDim in the source
ALPHA = 0.01  # LeakyReLU slope of the GAT logits

# The kernel's build constants (csrc/gat_cycle.cu), which the plan mirrors:
# threads a CTA, the rows (tile_rows, one build each) and columns a thread
# holds in a product, the k-chunk depth and the A chunks' row stride, the
# rings' depth, the most rows a tile has, the most column lanes, the
# largest cluster (portable) and the shared memory a block may use on the
# H100. The CPU tests read the source's values against these, and the card
# tests hold ``smem_bytes`` against the library's own.
THREADS = 256
TILE_ROWS = (4, 5, 6, 7, 8)
TILE_COLS = 12
K_CHUNK = 32
A_STRIDE = K_CHUNK + 4
STAGES = 2
MAX_ROWS = 128
MAX_COL_LANES = 16
MAX_CLUSTER = 8
SMEM_LIMIT = 232_448
SMS = 132  # the H100's SMs: at one CTA an SM, SMS // cluster clusters resident unless told


@dataclass(frozen=True)
class CyclePlan:
    """How one launch of kernel 2 spreads over the card: ``clusters``
    clusters of ``cluster`` CTAs (``ctas`` in all, ``waves`` = clusters
    over the clusters the card keeps resident); cluster c takes the videos
    ``cluster_videos``, at most ``videos_per_cluster`` (``rows_per_tile``
    = that x N rows, ``padded_rows`` to ``tile_rows``, the rows a thread
    holds); each CTA owns ``heads_per_cta`` heads, the ``cols_per_cta``
    columns [rank x cols_per_cta, ...), computed by ``col_lanes`` column
    lanes of TILE_COLS columns in ``col_passes`` windows, each chunk's k
    range split over ``k_split`` thread groups; ``smem_bytes`` of dynamic
    shared memory per CTA."""

    cluster: int
    heads_per_cta: int
    cols_per_cta: int
    clusters: int
    videos_per_cluster: int
    rows_per_tile: int
    tile_rows: int
    padded_rows: int
    col_lanes: int
    col_passes: int
    k_split: int
    ctas: int
    waves: float
    smem_bytes: int


def k_split(rows, tile_rows, col_lanes):
    """The source's ``ks``: the most thread groups (a power of 2) whose row
    lanes (``rows`` padded to ``tile_rows``, per lane) fit the CTA, each
    with 4 k or more of a chunk."""
    lanes, used, ks = THREADS // col_lanes, -(-rows // tile_rows), 1
    while 2 * ks * used <= lanes and 8 * ks <= K_CHUNK:
        ks *= 2
    return ks


def smem_bytes(n, d, heads, cluster, videos, col_lanes, tile_rows):
    """One CTA's shared memory for tiles of at most ``videos`` videos, the
    source's ``smem_bytes``: the weight ring (STAGES x K_CHUNK rows of
    col_lanes x TILE_COLS, or the K split's partial sums if more), the A
    ring (STAGES x padded rows of A_STRIDE), the GAT's rows (padded rows of
    cols + 4), the attention (videos x heads a CTA x N x N rounded up to
    4), the logit halves (2 x heads a CTA x padded rows), the partial
    scores and beta (3 x padded rows), all fp32."""
    rows = -(-videos * n // tile_rows) * tile_rows
    hpc, cw = heads // cluster, d // cluster
    ring = max(STAGES * K_CHUNK, (k_split(rows, tile_rows, col_lanes) - 1) * rows)
    return 4 * (ring * col_lanes * TILE_COLS + STAGES * rows * A_STRIDE + rows * (cw + 4) + 2 * hpc * rows
                + videos * hpc * n * -(-n // 4) * 4 + 3 * rows)


def dim_limits(n, d, heads=None):
    """Why the kernel cannot take N = ``n`` nodes, width D = ``d`` and
    ``heads`` heads (not asked if None): one message for each limit
    broken, none if it can."""
    out = []
    if n <= 0 or n > MAX_NODES:
        out.append(f"the graph-cycle kernel takes N <= {MAX_NODES} nodes, got {n}")
    if d <= 0 or d > MAX_DIM or d % 4:
        out.append(f"the graph-cycle kernel takes D <= {MAX_DIM} and a multiple of 4, got {d}")
    if heads is not None and (heads <= 0 or d % heads):
        out.append(f"the graph-cycle kernel takes H heads of hd columns, H*hd == D; got D={d}, H={heads}")
    return out


def _tile_rows(rows, col_lanes):
    """The rows a thread holds for a tile of ``rows`` rows: the one that
    keeps the most row lanes busy (with the K split), the most rows on a
    tie (fewer shared-memory reads an FMA); None if none fits MAX_ROWS."""
    lanes = THREADS // col_lanes
    fit = [tm for tm in TILE_ROWS if -(-rows // tm) <= lanes and -(-rows // tm) * tm <= MAX_ROWS]
    if not fit:
        return None
    return max(fit, key=lambda tm: (k_split(rows, tm, col_lanes) * -(-rows // tm), tm))


def cluster_sizes(d, heads):
    """The cluster sizes the kernel takes for these dims: CTAs that each own
    whole heads, a column slice that is a multiple of 4, at most
    MAX_CLUSTER CTAs."""
    return tuple(c for c in range(1, min(heads, MAX_CLUSTER) + 1) if heads % c == 0 and (d // c) % 4 == 0)


@functools.lru_cache(maxsize=None)
def cycle_plan(b, n, d, heads, resident=None, cluster=None):
    """The launch plan of kernel 2 for h (``b``, ``n``, ``d``) and ``heads``
    heads, on a card that keeps ``resident`` clusters of each size resident
    at once (pairs (cluster size, count); ``card_plan`` asks the card; by
    default SMS // size, one CTA an SM), with clusters of ``cluster`` CTAs
    if given, else of the size that costs least.

    For each cluster size (``cluster_sizes``): column lanes, one per
    TILE_COLS columns, at most MAX_COL_LANES, fewer if shared memory asks;
    of the cluster counts whose largest tile fits MAX_ROWS rows and shared
    memory, the one of least cost: rounds x (column passes x (tile_rows /
    k_split + 1) + 1), in units of a thread's FMAs for one row: the
    products, each pass's stream and a tile's fixed cost, as the cuts of
    ``bench/gat_kernel_ab.py`` measured them on the H100 (rounds: the
    clusters over those resident). The least cost wins, then the larger
    cluster (fewer weight reads a row), then more clusters. Cluster c takes videos [c b / clusters, (c + 1) b /
    clusters). Raises ``ValueError`` for dims the kernel does not take.
    """
    if b <= 0:
        raise ValueError(f"gat_cycle needs a batch, got B={b}")
    if broken := dim_limits(n, d, heads):
        raise ValueError("; ".join(broken))
    counts = dict(resident or ())
    best = None
    for size in (cluster,) if cluster else cluster_sizes(d, heads):
        cw = d // size
        res = max(1, counts.get(size, SMS // size))
        lanes = min(MAX_COL_LANES, -(-cw // TILE_COLS))

        def tile(k):
            tb = -(-b // k)
            tm = _tile_rows(tb * n, lanes)
            if tm is None or smem_bytes(n, d, heads, size, tb, lanes, tm) > SMEM_LIMIT:
                return None
            return tb, tm, k_split(tb * n, tm, lanes)

        while True:
            tiles = {k: t for k in range(1, b + 1) if (t := tile(k)) is not None}
            if tiles or lanes == 1:
                break
            lanes -= 1  # a narrower weight ring
        passes = -(-cw // (lanes * TILE_COLS))
        for k, (tb, tm, ks) in tiles.items():
            rounds = -(-k // res)
            key = (rounds * (passes * (tm / ks + 1) + 1), -size, -k)
            if best is None or key < best[0]:
                best = key, size, res, lanes, passes, k, tb, tm, ks
    if best is None:
        raise ValueError(f"gat_cycle: no tile of N={n}, D={d}, H={heads} fits {SMEM_LIMIT} bytes of shared memory")
    _, size, res, lanes, passes, clusters, tb, tm, ks = best
    return CyclePlan(cluster=size, heads_per_cta=heads // size, cols_per_cta=d // size, clusters=clusters,
                     videos_per_cluster=tb, rows_per_tile=tb * n, tile_rows=tm, padded_rows=-(-tb * n // tm) * tm,
                     col_lanes=lanes, col_passes=passes, k_split=ks, ctas=clusters * size, waves=clusters / res,
                     smem_bytes=smem_bytes(n, d, heads, size, tb, lanes, tm))


def cluster_videos(plan, b, c):
    """The videos cluster ``c`` takes, as the kernel computes them."""
    return range(c * b // plan.clusters, (c + 1) * b // plan.clusters)


def cta_columns(plan, rank):
    """The output columns CTA ``rank`` computes, pass by pass, as the
    kernel's column lanes cover them."""
    c0, window = rank * plan.cols_per_cta, plan.col_lanes * TILE_COLS
    cols = []
    for p in range(plan.col_passes):
        lo = p * window
        cols.extend(c0 + lo + lane * TILE_COLS + j for lane in range(plan.col_lanes) for j in range(TILE_COLS)
                    if lo + lane * TILE_COLS + j < plan.cols_per_cta)
    return cols


def plan_args(plan):
    """The plan's numbers in the order the C entries take them, after B, N,
    D and H."""
    return plan.cluster, plan.clusters, plan.col_lanes, plan.tile_rows


def library_smem_bytes(b, n, d, heads, plan):
    """The shared memory per CTA the library launches the plan with (the
    build's own formula); -1 if the build refuses the plan."""
    return call("gat_cycle_smem_bytes", None, b, n, d, heads, *plan_args(plan))


_resident: dict = {}


def active_clusters(b, n, d, heads, plan, dev=None):
    """How many of the plan's clusters the card (``dev``, or the current
    device) keeps resident at once (``cudaOccupancyMaxActiveClusters``);
    raises if the card refuses."""
    count = call("gat_cycle_active_clusters", dev, b, n, d, heads, *plan_args(plan))
    if count <= 0:
        raise RuntimeError(f"gat_cycle: the card keeps no cluster of {plan.cluster} CTAs resident (cudaError {-count})")
    return count


def card_plan(b, n, d, heads, dev=None):
    """``cycle_plan`` with the clusters of each size the card (``dev``, or
    the current device) keeps resident, asked once per device and dims
    (one CTA an SM, whatever the tile)."""
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None else dev
    key = (dev, n, d, heads)
    if key not in _resident:
        _resident[key] = tuple((size, active_clusters(b, n, d, heads, cycle_plan(b, n, d, heads, cluster=size), dev))
                               for size in cluster_sizes(d, heads))
    return cycle_plan(b, n, d, heads, _resident[key])


def _gat_block(x, scores, w, b, a, a_bias):
    """One punished multi-head GAT over x (B, N, D) -> (B, N, H*hd)."""
    bsz, n, _ = x.shape
    heads, hd = a.shape[0], a.shape[1] // 2
    wh = (x @ w + b).view(bsz, n, heads, hd)
    src = torch.einsum("bnhd,hd->bhn", wh, a[:, :hd])
    dst = torch.einsum("bnhd,hd->bhn", wh, a[:, hd:])
    e = F.leaky_relu(src[..., :, None] + dst[..., None, :] + a_bias[None, :, None, None], ALPHA)
    attn = torch.softmax(e, dim=-1)  # (B, H, N, N); the dense adjacency masks nothing
    out = torch.einsum("bhij,bjhd->bihd", attn, wh * scores[:, :, None, :])
    return F.elu(out).reshape(bsz, n, heads * hd)


def gat_cycle_reference(
    h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w
):
    """Plain PyTorch version of the cycle, with the kernel's contract."""
    common = _gat_block(h, scores, wc, bc, ac, ac_bias)
    spec = _gat_block(h, scores, ws, bs, a_s, as_bias)

    def score(z):
        return torch.tanh(z @ proj_w + proj_b) @ score_w  # (B, N, 1)

    beta = torch.sigmoid(score(common) - score(spec))
    return h + (beta * common + (1.0 - beta) * spec), common, spec


def gat_cycle(h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w):
    """One stream's cycle (see the module docstring). Returns (out, common, spec).
    Eval only: raises if grad mode is on and an input requires grad (the
    JAX package gives the TPU kernel no backward either). The work is the
    custom op ``dualvgr_torch::gat_cycle``, which ``torch.export`` keeps as
    one node of the graph."""
    args = (h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w)
    refuse_autograd("gat_cycle", *args)
    return dispatch("gat_cycle", h, _cycle_op, _cycle_op)(*args)


gat_cycle.launches = 0


@torch.library.custom_op(f"{OPS_NAMESPACE}::gat_cycle", mutates_args=(), device_types="cpu")
def _cycle_op(h: torch.Tensor, scores: torch.Tensor, wc: torch.Tensor, bc: torch.Tensor, ac: torch.Tensor,
              ac_bias: torch.Tensor, ws: torch.Tensor, bs: torch.Tensor, a_s: torch.Tensor,
              as_bias: torch.Tensor, proj_w: torch.Tensor, proj_b: torch.Tensor,
              score_w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op on CPU tensors: the plain version."""
    return gat_cycle_reference(h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w)


@_cycle_op.register_fake
def _(h, *_):
    return tuple(torch.empty_like(h) for _ in range(3))


@_cycle_op.register_kernel("cuda")
def _cycle_cuda(h, scores, wc, bc, ac, ac_bias, ws, bs, a_s, as_bias, proj_w, proj_b, score_w):
    """The op on CUDA tensors: one launch of ``csrc/gat_cycle.cu``."""
    dev = h.device
    if h.dim() != 3:
        raise ValueError(f"h must be (B, N, D), got {tuple(h.shape)}")
    bsz, n, d = h.shape
    heads = ac.shape[0]
    hd = ac.shape[1] // 2
    if heads * hd != d:
        raise ValueError(f"gat_cycle takes H*hd == D; got D={d}, H={heads}, hd={hd}")
    check("h", h, (bsz, n, d), dev)
    for name, t, shape in (
        ("wc", wc, (d, d)), ("bc", bc, (d,)), ("ac", ac, (heads, 2 * hd)), ("ac_bias", ac_bias, (heads,)),
        ("ws", ws, (d, d)), ("bs", bs, (d,)), ("a_s", a_s, (heads, 2 * hd)), ("as_bias", as_bias, (heads,)),
        ("proj_w", proj_w, (d, d)), ("proj_b", proj_b, (d,)), ("score_w", score_w, (d, 1)),
    ):
        check(name, t, shape, dev)
    # scores are read through their strides: QueryPunish's per-clip score
    # broadcast to the head width (stride 0) needs no copy
    if scores.device != dev or scores.dtype != torch.float32 or tuple(scores.shape) != (bsz, n, hd):
        raise ValueError(
            f"scores must be float32 ({bsz}, {n}, {hd}) on {dev}, got "
            f"{scores.dtype} {tuple(scores.shape)} on {scores.device}"
        )
    if min(scores.stride()) < 0:
        raise ValueError("scores must have non-negative strides")
    # h and the D x D weights are read 16 bytes at a time
    h, wc, ws, proj_w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (h, wc, ws, proj_w))
    out, common, spec = (torch.empty_like(h) for _ in range(3))
    plan = card_plan(bsz, n, d, heads, dev)
    launch(gat_cycle, "gat_cycle_launch", dev,
           h.data_ptr(), scores.data_ptr(), *scores.stride(),
           wc.data_ptr(), bc.data_ptr(), ac.data_ptr(), ac_bias.data_ptr(),
           ws.data_ptr(), bs.data_ptr(), a_s.data_ptr(), as_bias.data_ptr(),
           proj_w.data_ptr(), proj_b.data_ptr(), score_w.data_ptr(),
           out.data_ptr(), common.data_ptr(), spec.data_ptr(),
           bsz, n, d, heads, *plan_args(plan))
    return out, common, spec
