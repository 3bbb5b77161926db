// The forward BiLSTM recurrence as a thread-block cluster kernel: the design
// shared by kernel 1 (bilstm_recurrence.cu) and kernel 3
// (bilstm_train_fwd.cu), which includes its residual stores.
//
// What bounds it on the H100. Per step each (row, direction) needs an
// (H) @ (H, 4H) fp32 product against W_hh, 2.36 MB per direction at H = 384.
// One block's 227 KB of shared memory cannot hold that, so the previous
// design streamed all of W_hh from L2 on every step of every block: at the
// question shapes 4-row tiles made each loaded W value feed one FMA, and the
// kernel ran at about the L2's bandwidth, 11-12x its operation bound.
//
// Design. One cluster of `cluster` CTAs holds one direction's W_hh: CTA
// `rank` owns hidden units [rank * units, min((rank + 1) * units, H)) and
// keeps their 4 * units gate columns (kGateCols, zero-padded) of W_hh in its
// shared memory for the whole launch, loaded once per direction it works on.
// Clusters are persistent: the launch holds as many as the card can keep
// resident (cudaOccupancyMaxActiveClusters), and cluster c walks the work
// items [c * 2 * tiles / clusters, (c + 1) * 2 * tiles / clusters), item i
// being direction i / tiles and row tile i % tiles of kRows rows; it reloads
// its slice of W_hh when the direction changes (at most once).
//
// Every step:
//  1. each CTA waits until the tile's whole h_{t-1} has arrived (an mbarrier
//     counting bytes), then computes its gate columns for the tile's rows,
//     the product's K split over kSplit thread groups, each thread holding
//     kRowsPerThread rows x kColsPerThread columns in registers, 4 k at a
//     time (16-byte loads of h and of the column-major W slice); the groups'
//     partial sums meet in shared memory;
//  2. one thread per (row, unit) adds the step's input gates (loaded into
//     registers before the wait, so their latency hides behind it), applies
//     the cell update and the packed-length mask, and stores the outputs
//     (and kernel 3's residuals: the pre-step state and the gate
//     activations) of its own units; c and h of its pairs stay in its
//     registers for the whole tile;
//  3. the new h slice, staged in shared memory, goes to every CTA of the
//     cluster through distributed shared memory: one bulk async copy of the
//     tile's rows per destination CTA, completing on the destination's
//     mbarrier of the next h buffer. h is kept source-major for
//     that, [source CTA][row][its units], so each copy is one contiguous
//     block (a copy per row costs the copy engine 16 times as many
//     operations).
// h and its staging are double-buffered and the waits order everything
// else: a CTA that sends step t + 1's h into a buffer has itself received
// step t's h from every CTA, so each of them has
// finished reading that buffer (its step t product) and the staging the
// copies read from. A cluster barrier ends each item, so the next item's
// first copies find no reader. The first step starts from h = 0 and skips
// the wait and the product. The arithmetic is the plain loop's in fp32 FMA
// on the CUDA cores; only the order of the product's sums differs. There
// are no atomics, so two launches on the same inputs give the same bits.
//
// The launch plan (cluster, units, rows per tile, clusters) is computed in
// Python, ops/lstm_kernel.py::recurrence_plan, which the CPU tests cover;
// check_plan below refuses any plan this build cannot run.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bilstm_cluster {

namespace cg = cooperative_groups;

// The product's register tile: a thread holds kRowsPerThread rows x
// kColsPerThread columns and reads r + c values from shared memory for r c
// FMAs a k. 8 x 6 measured fastest of the tiles bench/rec_kernel_ab.py
// tries.
constexpr int kThreads = 256;
constexpr int kGateCols = 96;                               // gate columns a CTA holds
constexpr int kMaxUnits = kGateCols / 4;                    // hidden units a CTA owns
// A K group is a warp: kRowLanes row lanes x kColLanes column lanes,
// covering all kRows rows and all kGateCols columns.
constexpr int kRowLanes = 2, kColLanes = 32 / kRowLanes;
constexpr int kRowsPerThread = 8;
constexpr int kRows = kRowLanes * kRowsPerThread;           // rows per tile
constexpr int kColsPerThread = kGateCols / kColLanes;
constexpr int kSplit = kThreads / 32;                       // K groups of the product
constexpr int kRedBuffers = kSplit / 2;                     // groups g and g + kRedBuffers share one
constexpr int kPairSlots = (kRows * kMaxUnits + kThreads - 1) / kThreads;
constexpr int kMaxHidden = 384;
constexpr int kSmemLimit = 232448;
static_assert(kColsPerThread * kColLanes == kGateCols, "the column lanes cover the columns");

struct Params {
  const void* xf;
  const void* xb;
  const float* whf;
  const float* whb;
  const int* lengths;
  void* final_out;
  void* outs;
  float* hprev;  // kernel 3 only
  float* cprev;
  int T, R, H, units, tiles, clusters;
  // kernel 3 only: the gate activations (2, T, R, 4H), last so that kernel
  // 1's parameters keep their offsets
  float* acts;
};

// The column stride of the W slice: H + 4 floats, so the distinct columns
// of a warp's 16-byte shared-memory access fall on distinct banks; the
// partial sums' row stride kGateCols + kColLanes, so a warp's kRowLanes
// rows x kColLanes consecutive columns fall on distinct banks.
__host__ __device__ constexpr int slice_stride(int H) { return H + 4; }
constexpr int kRedStride = kGateCols + kColLanes;

// Dynamic shared memory of one CTA, for hidden size H split into cluster
// slices of `units` (hp = cluster * units >= H): an mbarrier per h buffer
// (16 bytes), the W slice [kGateCols][H + 4], h [2][cluster][kRows][units],
// the partial sums [kRedBuffers][kRows][kRedStride] and the staged new h
// [2][kRows][kMaxUnits].
__host__ __device__ constexpr int smem_bytes(int H, int hp) {
  return 16 + 4 * (kGateCols * slice_stride(H) + 2 * kRows * hp + kRedBuffers * kRows * kRedStride +
                   2 * kRows * kMaxUnits);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Gate loads as volatile asm, so the compiler issues them where they stand
// (before the wait and the product) instead of next to their use; a gate
// stays in its raw type (bf16 bits) until the cell update widens it, so no
// instruction waits for the load before the product.
template <typename TG> struct RawGate { using type = float; };
template <> struct RawGate<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ void load_gate(const float* p, float& v) {
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
}
__device__ __forceinline__ void load_gate(const __nv_bfloat16* p, unsigned short& v) {
  asm volatile("ld.global.nc.b16 %0, [%1];" : "=h"(v) : "l"(p));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(unsigned short v) { return __uint_as_float(static_cast<unsigned>(v) << 16); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of shared-memory address `a` in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t in_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// Returns once the barrier's phase `parity` has completed, with the bytes
// that completed it visible (acquire at cluster scope: other CTAs' copies
// wrote them). A wait of more than 2^34 cycles (about 10 s) can only be a
// fault: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// `bytes` from this CTA's shared memory to `dst` in another CTA's (or its
// own), counted on that CTA's barrier `bar` (both cluster addresses).
__device__ __forceinline__ void copy_to_rank(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// The slice of one direction's W_hh (H, 4H) that CTA `rank` keeps,
// column-major: column q * units + u, at ws + c * (H + 4), holds gate q of
// unit unit0 + u; columns past the CTA's own units are zero.
__device__ void load_slice(float* ws, const float* __restrict__ w, int H, int units, int unit0, int own) {
  const int stride = slice_stride(H);
  for (int i = threadIdx.x; i < H * kGateCols; i += kThreads) {
    const int k = i / kGateCols, c = i % kGateCols;
    const int q = c / units, u = c % units;
    ws[c * stride + k] = (q < 4 && u < own) ? __ldg(w + (size_t)k * 4 * H + q * H + unit0 + u) : 0.f;
  }
}

template <typename TG, typename TO, bool kResiduals>
__global__ void __launch_bounds__(kThreads, 1) recurrence_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / cs;
  const int T = p.T, R = p.R, H = p.H, units = p.units;
  const int unit0 = rank * units;
  const int own = max(0, min(units, H - unit0));  // a multiple of 4: H and units are
  const int stride = slice_stride(H);

  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);  // [2]: h buffer b has arrived
  float* ws = reinterpret_cast<float*>(smem4) + 4;      // [kGateCols][H + 4]
  const int hp = cs * units;                            // H padded to the slices
  float* hbuf = ws + kGateCols * stride;                // [2][cs][kRows][units]
  float* red = hbuf + 2 * kRows * hp;                   // [kRedBuffers][kRows][kRedStride]
  float* hs = red + kRedBuffers * kRows * kRedStride;   // [2][kRows][kMaxUnits]

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every CTA's barriers exist before any copy targets them
  uint32_t parity[2] = {0, 0};
  // the bytes of h_{t-1} that arrive for one step: a block of kRows x units
  // from every CTA that owns units
  const uint32_t step_bytes = kRows * units * 4 * ((H + units - 1) / units);

  // the product's thread layout: K group (a warp), row and column lane; the
  // thread's rows are rl + kRowLanes * i, its columns col0 + kColLanes * j
  const int grp = threadIdx.x / 32;
  const int rl = threadIdx.x % kRowLanes, col0 = (threadIdx.x % 32) / kRowLanes;
  const int kc = ((H + 4 * kSplit - 1) / (4 * kSplit)) * 4;
  const int k0 = min(H, grp * kc), k1 = min(H, k0 + kc);

  const int total = 2 * p.tiles;
  const int item0 = (int)((long long)cid * total / p.clusters);
  const int item1 = (int)((long long)(cid + 1) * total / p.clusters);
  int loaded = -1;

  for (int item = item0; item < item1; ++item) {
    const int dir = item / p.tiles;
    const int row0 = (item % p.tiles) * kRows;
    const TG* __restrict__ x = static_cast<const TG*>(dir ? p.xb : p.xf);
    if (dir != loaded) {
      // the previous item ended on a cluster barrier: no thread reads ws now
      load_slice(ws, dir ? p.whb : p.whf, H, units, unit0, own);
      loaded = dir;
      __syncthreads();
    }

    // the (row, unit) pairs this thread updates, their state and lengths
    int prow[kPairSlots], punit[kPairSlots], plen[kPairSlots];
    float hreg[kPairSlots], creg[kPairSlots];
#pragma unroll
    for (int s = 0; s < kPairSlots; ++s) {
      const int pi = threadIdx.x + s * kThreads;
      const bool on = own > 0 && pi < kRows * own;
      prow[s] = on ? pi / own : -1;
      punit[s] = on ? pi % own : 0;
      const int grow = row0 + max(prow[s], 0);
      // rows past R never enter a valid step: they stay at zero, never stored
      plen[s] = (on && grow < R) ? (p.lengths ? p.lengths[grow] : T) : 0;
      hreg[s] = 0.f;
      creg[s] = 0.f;
    }

    for (int t = 0; t < T; ++t) {
      const int cur = t & 1;
      const int tt = dir ? T - 1 - t : t;  // the backward half back in original time order
      // this step's input gates of the thread's pairs, in flight during the wait and the product
      typename RawGate<TG>::type gin[kPairSlots][4] = {};
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
        const int grow = row0 + max(prow[s], 0);
        const TG* g = x + ((size_t)t * R + grow) * 4 * H + unit0 + punit[s];
        if (prow[s] >= 0 && grow < R) {
#pragma unroll
          for (int q = 0; q < 4; ++q) load_gate(g + (size_t)q * H, gin[s][q]);
        }
      }

      // partial gates of this K group: h_{t-1}[rows, k0:k1] @ W_slice[k0:k1]
      float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) acc[r][j] = 0.f;
      int kend = k0;  // h_{-1} = 0: the first step has no product
      if (t > 0) {
        if (threadIdx.x == 0) mbar_arrive_expect_tx(smem_u32(&bars[cur]), step_bytes);
        mbar_wait(smem_u32(&bars[cur]), parity[cur]);
        parity[cur] ^= 1;
        kend = k1;
      }
      // h_{t-1}[row][k] is in block k / units at row, k % units
      const float* hrow = hbuf + cur * kRows * hp + rl * units;
      const float* wcol = ws + col0 * stride;
      int blk = k0 / units, off = k0 - blk * units;
#pragma unroll 2
      for (int k = k0; k < kend; k += 4) {
        float4 hv[kRowsPerThread], wv[kColsPerThread];
        const float* hk = hrow + blk * kRows * units + off;
        off += 4;
        if (off == units) off = 0, ++blk;
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          hv[r] = *reinterpret_cast<const float4*>(hk + r * kRowLanes * units);
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
      // the groups' partial sums: groups g and g + kRedBuffers meet in buffer
      // g, the upper one writing first
      float* mine = red + (grp % kRedBuffers * kRows + rl) * kRedStride + col0;
      if (grp >= kRedBuffers) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) mine[r * kRowLanes * kRedStride + j * kColLanes] = acc[r][j];
      }
      __syncthreads();
      if (grp < kRedBuffers) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) mine[r * kRowLanes * kRedStride + j * kColLanes] += acc[r][j];
      }
      __syncthreads();

      // the cell update of the thread's own pairs
      float* stage = hs + cur * kRows * kMaxUnits;  // [kRows][units]
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
        if (prow[s] < 0) continue;
        const int row = prow[s], u = punit[s];
        const int grow = row0 + row;
        const bool store = grow < R;
        if (kResiduals && store) {
          // the state this step starts from
          const size_t ri = ((size_t)t * R + grow) * 2 * H + dir * H + unit0 + u;
          p.hprev[ri] = hreg[s];
          p.cprev[ri] = creg[s];
        }
        float gate[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = widen(gin[s][q]);
#pragma unroll
          for (int g = 0; g < kRedBuffers; ++g) v += red[(g * kRows + row) * kRedStride + q * units + u];
          gate[q] = v;
        }
        // packed-sequence masks: the forward direction is valid while t < len;
        // the backward one (reversed time) from T - len on, zero before
        const bool valid = dir ? (t >= T - plen[s]) : (t < plen[s]);
        // kernel 3 keeps the step's activations i, f, g, o for the backward,
        // in the gates' layout; zeros at a masked step, which the backward
        // multiplies by m = 0 (finite, whatever the padding's gates hold)
        float* act = kResiduals ? p.acts + ((size_t)(dir * T + t) * R + grow) * 4 * H + unit0 + u : nullptr;
        if (valid) {
          const float ig = sigmoid_f(gate[0]), fg = sigmoid_f(gate[1]);
          const float gg = tanhf(gate[2]), og = sigmoid_f(gate[3]);
          creg[s] = fg * creg[s] + ig * gg;
          hreg[s] = og * tanhf(creg[s]);
          if (kResiduals && store) {
            const float a[4] = {ig, fg, gg, og};
#pragma unroll
            for (int q = 0; q < 4; ++q) act[q * H] = a[q];
          }
        } else if (kResiduals && store) {
#pragma unroll
          for (int q = 0; q < 4; ++q) act[q * H] = 0.f;
        }
        stage[row * units + u] = hreg[s];
        if (p.outs != nullptr && store)
          store_as(static_cast<TO*>(p.outs) + ((size_t)grow * T + tt) * 2 * H + dir * H + unit0 + u,
                   valid ? hreg[s] : 0.f);
        if (t == T - 1 && store)
          store_as(static_cast<TO*>(p.final_out) + (size_t)grow * 2 * H + dir * H + unit0 + u, hreg[s]);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the staging, visible to the copies
      __syncthreads();  // the stage is complete; every thread has read red

      if (t < T - 1 && own > 0) {
        // the new h slice, one block, into every CTA's next buffer: thread i
        // sends it to CTA i (the units past H go along unread)
        const int nxt = cur ^ 1;
        const float* dst = hbuf + (nxt * hp + unit0) * kRows;
        for (int i = threadIdx.x; i < cs; i += kThreads)
          copy_to_rank(in_rank(smem_u32(dst), i), smem_u32(stage), kRows * units * 4,
                       in_rank(smem_u32(&bars[nxt]), i));
      }
    }
    cluster.sync();  // every copy of this item has landed and been read
  }
}

// The numbers the Python plan passes, checked against this build.
inline bool check_plan(int T, int R, int H, int cluster, int units, int rows_per_tile, int clusters) {
  if (T <= 0 || R <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0) return false;
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16) return false;
  if (units <= 0 || units > kMaxUnits || units % 4 != 0 || cluster * units < H) return false;
  if (rows_per_tile != kRows) return false;
  const int tiles = (R + kRows - 1) / kRows;
  if (clusters < 1 || clusters > 2 * tiles) return false;
  return smem_bytes(H, cluster * units) <= kSmemLimit;
}

template <typename TG, typename TO, bool kResiduals>
cudaError_t configure(int H, int cluster, int units, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto* kernel = recurrence_kernel<TG, TO, kResiduals>;
  const int smem = smem_bytes(H, cluster * units);
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

// How many clusters of `cluster` CTAs the card keeps resident at once for
// hidden size H; 0 if it refuses the cluster (with the error returned).
template <typename TG, typename TO, bool kResiduals>
cudaError_t active_clusters(int H, int cluster, int units, int* count) {
  *count = 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TG, TO, kResiduals>(H, cluster, units, &cfg, attr);
  cfg.gridDim = dim3(cluster);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(count, recurrence_kernel<TG, TO, kResiduals>, &cfg);
}

template <typename TG, typename TO, bool kResiduals>
cudaError_t launch(const Params& p, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<TG, TO, kResiduals>(p.H, cluster, p.units, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(cluster * p.clusters);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, recurrence_kernel<TG, TO, kResiduals>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace bilstm_cluster
