// Backward of the bidirectional LSTM recurrence as a thread-block cluster
// kernel: fp32 arithmetic over fp32 or bf16 gates.
//
// Replaces the TPU kernel dualvgr_tpu/ops/lstm_pallas_train.py::_run_bwd_m
// (kernel body `_bwd_kernel_m`). Inputs: the forward's gates xf, xb (T, R, 4H,
// xb time-reversed), W_hh (H, 4H) per direction, optional packed lengths, the
// residuals hprev, cprev (T, R, 2H) written by bilstm_train_fwd.cu in kernel
// time, the gradient of the final state dfinal (R, 2H) and, for a forward
// with outputs, of the outputs douts (R, T, 2H, backward half in original
// time order, as the forward writes it; null for a final-only forward, and
// then never read). Output: dxf, dxb (T, R, 4H) in kernel time, the
// gradients of the gate inputs, which are the dgates (i, f, g, o). dW_hh =
// sum_t h_{t-1}^T dgates is left to one plain product outside, as the JAX
// package leaves it to XLA. The gates may be bf16 (the appearance op under
// compute_dtype: bfloat16), read as bf16 and widened; the dgates are fp32
// either way, as in the TPU kernel.
//
// Masked steps. With m the step's mask, h_t = m h~_t + (1 - m) h_{t-1} and
// out_t = m h~_t, so dh~ = m (dh + m dout), dh_{t-1} gains (1 - m)(dh + m dout),
// dc~ = m dc and dc_{t-1} gains (1 - m) dc; the dgates of a masked step are
// exactly zero. The masks in kernel time: forward t < len, backward
// t >= T - len.
//
// What bounds it on the H100. Each step of each (row, direction) needs two
// (H) x (H, 4H) fp32 products against W_hh: the gates again, from the
// residual h_{t-1}, and dh_{t-1} = dgates W_hh^T, 2 x 2 x 4H x H x 2 flops
// a row and step over both directions. The per-block design before this
// one streamed W_hh and a transposed copy (2 x 2.36 MB per direction) from
// L2 on every step of every block.
//
// Design: the forward's cluster design (bilstm_cluster.cuh), whose
// primitives it shares. One cluster of `cluster` CTAs holds one direction's
// W_hh: CTA `rank` owns hidden units [rank * units, min((rank + 1) * units,
// H)) and keeps their kGateCols gate columns of W_hh in shared memory for
// the whole launch. That one slice serves both products. Persistent clusters
// walk the (direction, row tile) items as in the forward, over kernel time
// from T - 1 down to 0, with the forward's tiles of kRows rows. A step t:
//  A. the gate product: the tile's h_{t-1} (the hprev residual, one bulk
//     async copy per row from global memory, issued during the previous
//     step) times the CTA's W slice, the forward's product (K split over the
//     warps, partial sums met in shared memory). It does not depend on the
//     backward carry;
//  D. the reduce of the previous step's dh partials: each owner of a (row,
//     unit) pair adds the kRows x units blocks that every CTA stored in
//     its receive buffer, in source order, to the part of dh that skipped
//     the cell. Placed after A, so the partials' flight hides behind the
//     gate product;
//  B. the cell backward, one thread per (row, unit) of the CTA's own units,
//     the carries dh and dc in that thread's registers: the four dgates go
//     to dx[t] and to a shared tile;
//  C. the partial dh_{t-1} = dgates[:, own columns] @ W_slice^T, rows x H,
//     reading the resident slice along its columns (so no W_hh^T), each
//     thread 8 rows x 3 outputs; the thread stores its partials straight
//     into the receive buffer of the CTA that owns each output (distributed
//     shared memory, source-major [source CTA][row][units]), and one thread
//     per destination then arrives on that CTA's "full" mbarrier. (Staging
//     the partials in the partial-sum buffer and sending one bulk copy per
//     destination, as the forward sends h, measured 3% slower at the
//     appearance shape: the staging has no room of its own, so its reuse
//     needs the handshake before the next gate sums, and the product's
//     registers stay live across it; PERF.md.)
// Every CTA sends rows x H floats a step, as in the forward's h exchange.
// The sums of D run in a fixed order and there are no atomics, so two
// launches on the same inputs give the same bits.
//
// Ordering. The receive buffer is single: after its reduce, a CTA arrives
// on every sender's "free" mbarrier, and a sender waits for all of them
// before it stores the next step's partials (the wait falls after its dh
// product, when the others have long finished their reduce). The h tile is
// single too: the next step's copy starts once the product has read it.
// The gate partial sums and the dgates share one buffer, their lives
// separated by a barrier. A cluster barrier ends each item.
//
// Shared memory at H = 384: the W slice 148,992 bytes, h 24,832, the gate
// partial sums (and dgates) 28,672, the receive buffer 24,576, the
// mbarriers 64: 227,136 of 232,448. The launch plan (cluster, units, rows
// per tile, clusters) is computed in Python,
// ops/lstm_kernel.py::backward_plan, which the CPU tests cover;
// check_bwd_plan below refuses any plan this build cannot run.

#include "bilstm_cluster.cuh"

namespace {

using namespace bilstm_cluster;

// The gate product takes the forward's layout and tile (kRows rows, the
// K range split over kSplit warps, partial sums in kRedBuffers buffers of
// stride kRedStride); kPairSlots (row, unit) pairs a thread.
constexpr int kMaxSenders = 16;                // the largest cluster
// The dh product's layout: kDhRowGroups groups of kDhRows rows, kDhLanes
// lanes a group over the H outputs of a row, kDhCols outputs a lane
// (k = lane + kDhLanes * j).
constexpr int kDhRowGroups = 2;
constexpr int kDhRows = kRows / kDhRowGroups;
constexpr int kDhLanes = kThreads / kDhRowGroups;
constexpr int kDhCols = kMaxHidden / kDhLanes;
static_assert(kDhCols * kDhLanes == kMaxHidden, "the dh lanes cover the hidden units");
static_assert(kRows * kGateCols <= kRedBuffers * kRows * kRedStride, "the dgates fit the partial sums");

// Dynamic shared memory of one CTA, in this order: the mbarriers (64
// bytes), the W slice [kGateCols][H + 4], h [kRows][H + 4], the gate
// partial sums [kRedBuffers][kRows][kRedStride] (the dgates
// [kRows][kGateCols] in the same place) and the receive buffer
// [cluster][kRows][units].
__host__ __device__ constexpr int bwd_smem_bytes(int H, int hp) {
  return 4 * (16 + kGateCols * slice_stride(H) + kRows * slice_stride(H) + kRedBuffers * kRows * kRedStride +
              kRows * hp);
}

// `bytes` from global memory into this CTA's shared memory, counted on its
// barrier `bar`.
__device__ __forceinline__ void copy_from_global(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// A store into another CTA's shared memory (a cluster address).
__device__ __forceinline__ void store_remote(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// One arrival on another CTA's mbarrier (a cluster address), releasing at
// cluster scope what this CTA did before it (the CTA's barrier just
// before orders the other threads' loads and stores).
__device__ __forceinline__ void arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

struct BwdParams {
  const void* xf;
  const void* xb;
  const float* whf;
  const float* whb;
  const int* lengths;
  const float* hprev;
  const float* cprev;
  const float* dfinal;
  const float* douts;
  float* dxf;
  float* dxb;
  int T, R, H, units, tiles, clusters;
};

template <typename TG>
__global__ void __launch_bounds__(kThreads, 1) bwd_kernel(const BwdParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;
  const int T = p.T, R = p.R, H = p.H, units = p.units;
  const int unit0 = rank * units;
  const int own = max(0, min(units, H - unit0));  // a multiple of 4, as H and units are
  const int stride = slice_stride(H);
  const int senders = (H + units - 1) / units;     // the CTAs that own units

  extern __shared__ float4 smem4[];
  // [0]: h arrived (bytes); [1]: the receive buffer is full (an arrival
  // from each sender); [2]: this CTA's partials may be stored (an arrival
  // from each receiver)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* ws = reinterpret_cast<float*>(smem4) + 16;    // [kGateCols][H + 4]
  float* hbuf = ws + kGateCols * stride;                // [kRows][H + 4]
  float* red = hbuf + kRows * stride;               // [kRedBuffers][kRows][kRedStride]
  float* dg = red;                                      // [kRows][kGateCols], after the cell's reads
  float* recv = red + kRedBuffers * kRows * kRedStride;  // [cs][kRows][units]

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), senders);
    mbar_init(smem_u32(&bars[2]), senders);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every CTA's barriers exist before anyone targets them
  uint32_t hpar = 0, fullpar = 0, freepar = 0;

  // the gate product's thread layout: K group (a warp), row and column
  // lane; the thread's rows are rl + kRowLanes * i, its columns col0 +
  // kColLanes * j
  const int grp = threadIdx.x / 32;
  const int rl = threadIdx.x % kRowLanes, col0 = (threadIdx.x % 32) / kRowLanes;
  const int kc = ((H + 4 * kSplit - 1) / (4 * kSplit)) * 4;
  const int k0 = min(H, grp * kc), k1 = min(H, k0 + kc);
  // the dh product's: rows drow0 .. drow0 + kDhRows, outputs dlane + kDhLanes * j
  const int drow0 = threadIdx.x / kDhLanes * kDhRows, dlane = threadIdx.x % kDhLanes;
  // each output's place in its owner's receive buffer (row 0), as a
  // cluster address (outputs past H have none)
  const float* my_slot = recv + rank * kRows * units;
  uint32_t dst[kDhCols];
#pragma unroll
  for (int j = 0; j < kDhCols; ++j) {
    const int k = min(dlane + j * kDhLanes, H - 1);
    dst[j] = in_rank(smem_u32(my_slot + k % units), k / units);
  }

  const int total = 2 * p.tiles;
  const int item0 = (int)((long long)cid * total / p.clusters);
  const int item1 = (int)((long long)(cid + 1) * total / p.clusters);
  int loaded = -1;

  for (int item = item0; item < item1; ++item) {
    const int dir = item / p.tiles;
    const int row0 = (item % p.tiles) * kRows;
    const int rows = min(kRows, R - row0);  // rows of the tile inside R
    const TG* __restrict__ x = static_cast<const TG*>(dir ? p.xb : p.xf);
    float* __restrict__ dx = dir ? p.dxb : p.dxf;
    // the previous item ended on a cluster barrier: no thread reads ws or
    // hbuf now, and no copy or store is in flight
    if (dir != loaded) {
      load_slice(ws, dir ? p.whb : p.whf, H, units, unit0, own);
      loaded = dir;
    }
    // rows past R are never copied: zero, so their gates stay finite
    for (int i = rows * stride + threadIdx.x; i < kRows * stride; i += kThreads) hbuf[i] = 0.f;
    __syncthreads();
    const uint32_t h_bytes = rows * H * 4;
    auto fetch_h = [&](int t) {
      // h_{t-1} of the tile's rows: one copy per row, on the h barrier
      if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive_expect_tx(smem_u32(&bars[0]), h_bytes);
      }
      if ((int)threadIdx.x < rows)
        copy_from_global(smem_u32(hbuf + threadIdx.x * stride),
                         p.hprev + ((size_t)t * R + row0 + threadIdx.x) * 2 * H + dir * H, H * 4,
                         smem_u32(&bars[0]));
    };
    fetch_h(T - 1);

    // the (row, unit) pairs this thread owns, their carries and lengths
    int prow[kPairSlots], punit[kPairSlots], plen[kPairSlots];
    float dh[kPairSlots], dc[kPairSlots], skip[kPairSlots];
#pragma unroll
    for (int s = 0; s < kPairSlots; ++s) {
      const int pi = threadIdx.x + s * kThreads;
      const bool on = own > 0 && pi < kRows * own;
      prow[s] = on ? pi / own : -1;
      punit[s] = on ? pi % own : 0;
      const int grow = row0 + max(prow[s], 0);
      const bool live = on && grow < R;
      // rows past R never enter a valid step: their dgates are zero, never stored
      plen[s] = live ? (p.lengths ? p.lengths[grow] : T) : 0;
      dh[s] = live ? p.dfinal[(size_t)grow * 2 * H + dir * H + unit0 + punit[s]] : 0.f;
      dc[s] = 0.f;
      skip[s] = 0.f;
    }

    for (int t = T - 1; t >= 0; --t) {
      // this step's input gates, c_{t-1} and dout of the thread's pairs, in
      // flight during the wait and the product
      typename RawGate<TG>::type gin[kPairSlots][4] = {};
      float c_prev[kPairSlots], dout[kPairSlots];
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
        c_prev[s] = dout[s] = 0.f;
        const int grow = row0 + max(prow[s], 0);
        if (prow[s] >= 0 && grow < R) {
          const size_t col = (size_t)dir * H + unit0 + punit[s];
          const TG* g = x + ((size_t)t * R + grow) * 4 * H + unit0 + punit[s];
#pragma unroll
          for (int q = 0; q < 4; ++q) load_gate(g + (size_t)q * H, gin[s][q]);
          load_gate(p.cprev + ((size_t)t * R + grow) * 2 * H + col, c_prev[s]);
          if (p.douts != nullptr)
            load_gate(p.douts + ((size_t)grow * T + (dir ? T - 1 - t : t)) * 2 * H + col, dout[s]);
        }
      }

      // A. partial gates of this K group: h_{t-1}[rows, k0:k1] @ W_slice[k0:k1]
      mbar_wait(smem_u32(&bars[0]), hpar);
      hpar ^= 1;
      {
        float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;
        const float* hrow = hbuf + rl * stride;
        const float* wcol = ws + col0 * stride;
#pragma unroll 1
        for (int k = k0; k < k1; k += 4) {
          float4 hv[kRowsPerThread], wv[kColsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
            hv[r] = *reinterpret_cast<const float4*>(hrow + r * kRowLanes * stride + k);
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            wv[j] = *reinterpret_cast<const float4*>(wcol + j * kColLanes * stride + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j)
#pragma unroll
              for (int r = 0; r < kRowsPerThread; ++r)
                acc[r][j] = fmaf(lane_of(hv[r], kk), lane_of(wv[j], kk), acc[r][j]);
        }
        // the groups' partial sums: groups g and g + kRedBuffers meet in
        // buffer g, the upper one writing first
        float* mine = red + (grp % kRedBuffers * kRows + rl) * kRedStride + col0;
        if (grp >= kRedBuffers) {
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j) mine[r * kRowLanes * kRedStride + j * kColLanes] = acc[r][j];
        }
        __syncthreads();  // also: every read of hbuf is done
        if (t > 0) fetch_h(t - 1);
        if (grp < kRedBuffers) {
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
            for (int j = 0; j < kColsPerThread; ++j) mine[r * kRowLanes * kRedStride + j * kColLanes] += acc[r][j];
        }
      }

      // D. dh_t: the part that skipped the cell plus step t + 1's partials,
      // summed in source order
      if (t < T - 1 && own > 0) {
        mbar_wait(smem_u32(&bars[1]), fullpar);
        fullpar ^= 1;
#pragma unroll
        for (int s = 0; s < kPairSlots; ++s) {
          if (prow[s] < 0) continue;
          const float* rv = recv + prow[s] * units + punit[s];
          float part[kMaxSenders];  // all loads first, then the sum in order
#pragma unroll
          for (int i = 0; i < kMaxSenders; ++i) part[i] = i < senders ? rv[i * kRows * units] : 0.f;
          float sum = skip[s];
#pragma unroll
          for (int i = 0; i < kMaxSenders; ++i) sum += part[i];
          dh[s] = sum;
        }
      }
      __syncthreads();  // the gate sums are complete; every read of recv is done
      if (t < T - 1 && t > 0 && own > 0) {
        // the receive buffer is free again: tell every sender
        for (int i = threadIdx.x; i < senders; i += kThreads) arrive_remote(in_rank(smem_u32(&bars[2]), i));
      }

      // B. the cell backward of the thread's pairs: first their gates
      float gate[kPairSlots][4];
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
        if (prow[s] < 0) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = widen(gin[s][q]);
#pragma unroll
          for (int g = 0; g < kRedBuffers; ++g)
            v += red[(g * kRows + prow[s]) * kRedStride + q * units + punit[s]];
          gate[s][q] = v;
        }
      }
      __syncthreads();  // every read of red is done: the dgates take its place
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
        if (prow[s] < 0) continue;
        float* drow = dg + prow[s] * kGateCols + punit[s];
        const int grow = row0 + prow[s];
        const float m = (dir ? (t >= T - plen[s]) : (t < plen[s])) ? 1.f : 0.f;
        const float ig = sigmoid_f(gate[s][0]), fg = sigmoid_f(gate[s][1]);
        const float gg = tanhf(gate[s][2]), og = sigmoid_f(gate[s][3]);
        const float tc = tanhf(fg * c_prev[s] + ig * gg);
        const float dh_tot = dh[s] + m * dout[s];
        const float dh_in = m * dh_tot;
        const float dcell = m * dc[s] + dh_in * og * (1.f - tc * tc);
        const float d4[4] = {dcell * gg * ig * (1.f - ig), dcell * c_prev[s] * fg * (1.f - fg),
                             dcell * ig * (1.f - gg * gg), dh_in * tc * og * (1.f - og)};
#pragma unroll
        for (int q = 0; q < 4; ++q) drow[q * units] = d4[q];
        if (grow < R) {
          float* out = dx + ((size_t)t * R + grow) * 4 * H + unit0 + punit[s];
#pragma unroll
          for (int q = 0; q < 4; ++q) out[(size_t)q * H] = d4[q];
        }
        skip[s] = (1.f - m) * dh_tot;
        dc[s] = (1.f - m) * dc[s] + dcell * fg;
      }
      if (t == 0 || own == 0) {
        __syncthreads();  // the dgates' place is red again next step
        continue;  // dh_{-1} is not needed; a CTA without units sends nothing
      }
      // the gate columns of units past the own ones: zero, as their W
      // columns (the product reads the 4 * units columns)
      if (own < units) {
        for (int i = threadIdx.x; i < kRows * 4 * units; i += kThreads) {
          const int c = i % (4 * units);
          if (c % units >= own) dg[i / (4 * units) * kGateCols + c] = 0.f;
        }
      }
      __syncthreads();  // the dgates tile is complete

      // C. partial dh_{t-1}[row][k] = sum over the own columns c of
      // dgates[row][c] W_slice[c][k]
      float acc2[kDhRows][kDhCols];
#pragma unroll
      for (int r = 0; r < kDhRows; ++r)
#pragma unroll
        for (int j = 0; j < kDhCols; ++j) acc2[r][j] = 0.f;
      int kj[kDhCols];
#pragma unroll
      for (int j = 0; j < kDhCols; ++j) kj[j] = min(dlane + j * kDhLanes, H - 1);
      const float* dgr = dg + drow0 * kGateCols;
#pragma unroll 2
      for (int c = 0; c < 4 * units; c += 4) {
        float4 dv[kDhRows];
#pragma unroll
        for (int r = 0; r < kDhRows; ++r) dv[r] = *reinterpret_cast<const float4*>(dgr + r * kGateCols + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* wc = ws + (c + cc) * stride;
#pragma unroll
          for (int j = 0; j < kDhCols; ++j) {
            const float w = wc[kj[j]];
#pragma unroll
            for (int r = 0; r < kDhRows; ++r) acc2[r][j] = fmaf(lane_of(dv[r], cc), w, acc2[r][j]);
          }
        }
      }
      // each receiver has read the previous partials (none before this item's first)
      if (t < T - 1) {
        mbar_wait(smem_u32(&bars[2]), freepar);
        freepar ^= 1;
      }
#pragma unroll
      for (int j = 0; j < kDhCols; ++j) {
        if (dlane + j * kDhLanes >= H) continue;
#pragma unroll
        for (int r = 0; r < kDhRows; ++r) store_remote(dst[j] + (drow0 + r) * units * 4, acc2[r][j]);
      }
      __syncthreads();  // every partial is stored; every read of dg is done
      for (int i = threadIdx.x; i < senders; i += kThreads) arrive_remote(in_rank(smem_u32(&bars[1]), i));
    }
    cluster.sync();  // every partial of this item has landed and been read
  }
}

// The numbers the Python plan passes, checked against this build.
bool check_bwd_plan(int T, int R, int H, int cluster, int units, int rows_per_tile, int clusters) {
  if (T <= 0 || R <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16) return false;
  if (units <= 0 || units > kMaxUnits || units % 4 != 0 || cluster * units < H) return false;
  if (rows_per_tile != kRows) return false;
  const int tiles = (R + kRows - 1) / kRows;
  if (clusters < 1 || clusters > 2 * tiles) return false;
  return bwd_smem_bytes(H, cluster * units) <= kSmemLimit;
}

template <typename TG>
cudaError_t configure_bwd(int H, int cluster, int units, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto* kernel = bwd_kernel<TG>;
  const int smem = bwd_smem_bytes(H, cluster * units);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <typename TG>
cudaError_t active_clusters_as(int H, int cluster, int units, int* count) {
  *count = 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure_bwd<TG>(H, cluster, units, &cfg, attr);
  cfg.gridDim = dim3(cluster);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, bwd_kernel<TG>, &cfg);
}

template <typename TG>
cudaError_t launch_as(const BwdParams& p, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure_bwd<TG>(p.H, cluster, p.units, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(cluster * p.clusters);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, bwd_kernel<TG>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `douts` may be null.
// gate_dtype: 0 for fp32 gates, 1 for bf16. The plan's numbers (cluster
// size, units per CTA, rows per tile, clusters launched) come from
// ops/lstm_kernel.py::backward_plan. Returns the cudaError_t of the launch
// (0 = cudaSuccess), cudaErrorInvalidValue (1) for a plan this build cannot
// run.
extern "C" int bilstm_train_bwd_launch(const void* xf, const void* xb, const void* whf, const void* whb,
                                       const void* lengths, const void* hprev, const void* cprev,
                                       const void* dfinal, const void* douts, void* dxf, void* dxb, int T, int R,
                                       int H, int gate_dtype, int cluster, int units, int rows_per_tile,
                                       int clusters, void* stream) {
  if ((gate_dtype != 0 && gate_dtype != 1) || !check_bwd_plan(T, R, H, cluster, units, rows_per_tile, clusters))
    return (int)cudaErrorInvalidValue;
  const BwdParams p{xf, xb, static_cast<const float*>(whf), static_cast<const float*>(whb),
                    static_cast<const int*>(lengths), static_cast<const float*>(hprev),
                    static_cast<const float*>(cprev), static_cast<const float*>(dfinal),
                    static_cast<const float*>(douts), static_cast<float*>(dxf), static_cast<float*>(dxb),
                    T, R, H, units, (R + rows_per_tile - 1) / rows_per_tile, clusters};
  const cudaError_t err = gate_dtype == 1 ? launch_as<__nv_bfloat16>(p, cluster, stream)
                                          : launch_as<float>(p, cluster, stream);
  return (int)err;
}

// How many clusters of `cluster` CTAs the card keeps resident at once for
// hidden size H; minus the cudaError_t if it refuses the cluster.
extern "C" int bilstm_train_bwd_active_clusters(int H, int cluster, int units, int gate_dtype) {
  int count = 0;
  const cudaError_t err = gate_dtype == 1 ? active_clusters_as<__nv_bfloat16>(H, cluster, units, &count)
                                          : active_clusters_as<float>(H, cluster, units, &count);
  return err == cudaSuccess ? count : -(int)err;
}

// The dynamic shared memory per CTA the kernel launches with.
extern "C" int bilstm_train_bwd_smem_bytes(int H, int cluster, int units) {
  return bwd_smem_bytes(H, cluster * units);
}
