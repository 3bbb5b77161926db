// Backward of the bidirectional LSTM recurrence as a thread-block cluster
// kernel, in fp32.
//
// Replaces the TPU kernel dualvgr_tpu/ops/lstm_pallas_train.py::_run_bwd_m
// (kernel body `_bwd_kernel_m`). Inputs: the gate activations acts (2, T, R,
// 4H: sigmoid i, sigmoid f, tanh g, sigmoid o of each step, direction-major,
// zero at a masked step) and the residual cprev (T, R, 2H), both written by
// bilstm_train_fwd.cu in kernel time, W_hh (H, 4H) per direction, optional
// packed lengths, the gradient of the final state dfinal (R, 2H) and, for a
// forward with outputs, of the outputs douts (R, T, 2H, backward half in
// original time order, as the forward writes it; null for a final-only
// forward, and then never read). Output: dxf, dxb (T, R, 4H) in kernel
// time, the gradients of the gate inputs, which are the dgates (i, f, g,
// o). dW_hh = sum_t h_{t-1}^T dgates is left to one plain product outside,
// as the JAX package leaves it to XLA. The activations are fp32 whatever
// the forward's gates were (fp32 or bf16), so this kernel has one type.
//
// Masked steps. With m the step's mask, h_t = m h~_t + (1 - m) h_{t-1} and
// out_t = m h~_t, so dh~ = m (dh + m dout), dh_{t-1} gains (1 - m)(dh + m dout),
// dc~ = m dc and dc_{t-1} gains (1 - m) dc; the dgates of a masked step are
// exactly zero (the forward stored zero activations there, so nothing
// non-finite meets m = 0). The masks in kernel time: forward t < len,
// backward t >= T - len.
//
// What bounds it on the H100. Each step of each (row, direction) needs one
// (H) x (H, 4H) fp32 product against W_hh, dh_{t-1} = dgates W_hh^T, 2 x 4H
// x H x 2 flops a row and step over both directions: the forward's own
// count. The gates themselves are the forward's: it keeps their activations
// (805 MB at the appearance shape, T 16, R 4096, H 384: 0.24 ms of HBM
// time) where recomputing them took a second product as large as this one.
//
// Design: the forward's cluster design (bilstm_cluster.cuh), whose
// primitives it shares. One cluster of `cluster` CTAs holds one direction's
// W_hh: CTA `rank` owns hidden units [rank * units, min((rank + 1) * units,
// H)) and keeps their kGateCols gate columns of W_hh in shared memory for
// the whole launch. Persistent clusters walk the (direction, row tile)
// items as in the forward, over kernel time from T - 1 down to 0, with the
// forward's tiles of kRows rows. A step t:
//  D. the reduce of the previous step's dh partials: each owner of a (row,
//     unit) pair adds the kRows x units blocks that every CTA stored in
//     its receive buffer, in source order, to the part of dh that skipped
//     the cell;
//  B. the cell backward, one thread per (row, unit) of the CTA's own units,
//     the carries dh and dc in that thread's registers, from the step's
//     activations, c_{t-1} and dout (loaded during the previous step's
//     product): the four dgates go to dx[t] and to a shared tile;
//  C. the partial dh_{t-1} = dgates[:, own columns] @ W_slice^T, rows x H,
//     reading the resident slice along its columns (so no W_hh^T), each
//     thread 8 rows x 3 outputs; the thread stores its partials straight
//     into the receive buffer of the CTA that owns each output (distributed
//     shared memory, source-major [source CTA][row][units]), and one thread
//     per destination then arrives on that CTA's "full" mbarrier.
// Every CTA sends rows x H floats a step, as in the forward's h exchange.
// The sums of D run in a fixed order and there are no atomics, so two
// launches on the same inputs give the same bits.
//
// Ordering. The receive buffer is single: after its reduce (and the cell,
// behind one CTA barrier), a CTA arrives on every sender's "free" mbarrier,
// and a sender waits for all of them before it stores the next step's
// partials (the wait falls after its dh product, when the others have long
// finished their reduce). The dgates tile is read by the product and
// rewritten by the next step's cell, the two separated by the barrier after
// the partials' stores: two CTA barriers a step. A cluster barrier ends
// each item.
//
// Shared memory at H = 384: the mbarriers 16 bytes, the W slice 148,992,
// the dgates 6,144, the receive buffer 24,576: 179,728 of 232,448. The
// launch plan (cluster, units, rows per tile, clusters) is computed in
// Python, ops/lstm_kernel.py::backward_plan, which the CPU tests cover;
// check_bwd_plan below refuses any plan this build cannot run.

#include "bilstm_cluster.cuh"

namespace {

using namespace bilstm_cluster;

// kPairSlots (row, unit) pairs a thread, as in the forward.
constexpr int kMaxSenders = 16;                // the largest cluster
// The dh product's layout: kDhRowGroups groups of kDhRows rows, kDhLanes
// lanes a group over the H outputs of a row, kDhCols outputs a lane
// (k = lane + kDhLanes * j).
constexpr int kDhRowGroups = 2;
constexpr int kDhRows = kRows / kDhRowGroups;
constexpr int kDhLanes = kThreads / kDhRowGroups;
constexpr int kDhCols = kMaxHidden / kDhLanes;
static_assert(kDhCols * kDhLanes == kMaxHidden, "the dh lanes cover the hidden units");

// Dynamic shared memory of one CTA, in this order: the two mbarriers (16
// bytes), the W slice [kGateCols][H + 4], the dgates [kRows][kGateCols]
// and the receive buffer [cluster][kRows][units].
__host__ __device__ constexpr int bwd_smem_bytes(int H, int hp) {
  return 4 * (4 + kGateCols * slice_stride(H) + kRows * kGateCols + kRows * hp);
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
  const float* acts;
  const float* whf;
  const float* whb;
  const int* lengths;
  const float* cprev;
  const float* dfinal;
  const float* douts;
  float* dxf;
  float* dxb;
  int T, R, H, units, tiles, clusters;
};

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
  // [0]: the receive buffer is full (an arrival from each sender); [1]:
  // this CTA's partials may be stored (an arrival from each receiver)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* ws = reinterpret_cast<float*>(smem4) + 4;     // [kGateCols][H + 4]
  float* dg = ws + kGateCols * stride;                 // [kRows][kGateCols]
  float* recv = dg + kRows * kGateCols;                // [cs][kRows][units]

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bars[0]), senders);
    mbar_init(smem_u32(&bars[1]), senders);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the gate columns of units past the own ones stay zero, as their W
  // columns (the product reads the 4 * units columns; the cell writes only
  // the own ones)
  for (int i = threadIdx.x; i < kRows * kGateCols; i += kThreads) dg[i] = 0.f;
  cluster.sync();  // every CTA's barriers exist before anyone targets them
  uint32_t fullpar = 0, freepar = 0;

  // the dh product's layout: rows drow0 .. drow0 + kDhRows, outputs dlane + kDhLanes * j
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
    const float* __restrict__ act = p.acts + (size_t)dir * T * R * 4 * H;
    float* __restrict__ dx = dir ? p.dxb : p.dxf;
    // the previous item ended on a cluster barrier: no thread reads ws now,
    // and no store is in flight; the first read of the new slice follows a
    // CTA barrier
    if (dir != loaded) {
      load_slice(ws, dir ? p.whb : p.whf, H, units, unit0, own);
      loaded = dir;
    }

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

    // a step's activations, c_{t-1} and dout of the thread's pairs, loaded
    // a step ahead: in flight during the previous step's dh product
    float a[kPairSlots][4], c_prev[kPairSlots], dout[kPairSlots];
    auto fetch = [&](int t) {
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
#pragma unroll
        for (int q = 0; q < 4; ++q) a[s][q] = 0.f;
        c_prev[s] = dout[s] = 0.f;
        const int grow = row0 + max(prow[s], 0);
        if (prow[s] >= 0 && grow < R) {
          const size_t col = (size_t)dir * H + unit0 + punit[s];
          const float* g = act + ((size_t)t * R + grow) * 4 * H + unit0 + punit[s];
#pragma unroll
          for (int q = 0; q < 4; ++q) load_gate(g + (size_t)q * H, a[s][q]);
          load_gate(p.cprev + ((size_t)t * R + grow) * 2 * H + col, c_prev[s]);
          if (p.douts != nullptr)
            load_gate(p.douts + ((size_t)grow * T + (dir ? T - 1 - t : t)) * 2 * H + col, dout[s]);
        }
      }
    };
    fetch(T - 1);

    for (int t = T - 1; t >= 0; --t) {
      // D. dh_t: the part that skipped the cell plus step t + 1's partials,
      // summed in source order
      if (t < T - 1 && own > 0) {
        mbar_wait(smem_u32(&bars[0]), fullpar);
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

      // B. the cell backward of the thread's pairs
#pragma unroll
      for (int s = 0; s < kPairSlots; ++s) {
        if (prow[s] < 0) continue;
        float* drow = dg + prow[s] * kGateCols + punit[s];
        const int grow = row0 + prow[s];
        const float m = (dir ? (t >= T - plen[s]) : (t < plen[s])) ? 1.f : 0.f;
        const float ig = a[s][0], fg = a[s][1], gg = a[s][2], og = a[s][3];
        const float tc = tanhf(fg * c_prev[s] + ig * gg);  // the forward's tanh(c_t)
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
      if (t > 0) fetch(t - 1);
      // dh_{-1} is not needed, and a CTA without units sends nothing; the
      // item's cluster barrier orders what the last step read and wrote
      if (t == 0 || own == 0) continue;
      __syncthreads();  // the dgates tile is complete; every read of recv is done
      if (t < T - 1) {
        // the receive buffer is free again: tell every sender
        for (int i = threadIdx.x; i < senders; i += kThreads) arrive_remote(in_rank(smem_u32(&bars[1]), i));
      }

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
        mbar_wait(smem_u32(&bars[1]), freepar);
        freepar ^= 1;
      }
#pragma unroll
      for (int j = 0; j < kDhCols; ++j) {
        if (dlane + j * kDhLanes >= H) continue;
#pragma unroll
        for (int r = 0; r < kDhRows; ++r) store_remote(dst[j] + (drow0 + r) * units * 4, acc2[r][j]);
      }
      __syncthreads();  // every partial is stored; every read of dg is done
      for (int i = threadIdx.x; i < senders; i += kThreads) arrive_remote(in_rank(smem_u32(&bars[0]), i));
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

cudaError_t configure_bwd(int H, int cluster, int units, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  auto* kernel = bwd_kernel;
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

cudaError_t launch_bwd(const BwdParams& p, int cluster, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure_bwd(p.H, cluster, p.units, &cfg, attr);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(cluster * p.clusters);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, bwd_kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `douts` may be null.
// The plan's numbers (cluster size, units per CTA, rows per tile, clusters
// launched) come from ops/lstm_kernel.py::backward_plan. Returns the
// cudaError_t of the launch (0 = cudaSuccess), cudaErrorInvalidValue (1)
// for a plan this build cannot run.
extern "C" int bilstm_train_bwd_launch(const void* acts, const void* whf, const void* whb, const void* lengths,
                                       const void* cprev, const void* dfinal, const void* douts, void* dxf,
                                       void* dxb, int T, int R, int H, int cluster, int units, int rows_per_tile,
                                       int clusters, void* stream) {
  if (!check_bwd_plan(T, R, H, cluster, units, rows_per_tile, clusters)) return (int)cudaErrorInvalidValue;
  const BwdParams p{static_cast<const float*>(acts), static_cast<const float*>(whf),
                    static_cast<const float*>(whb), static_cast<const int*>(lengths),
                    static_cast<const float*>(cprev), static_cast<const float*>(dfinal),
                    static_cast<const float*>(douts), static_cast<float*>(dxf), static_cast<float*>(dxb),
                    T, R, H, units, (R + rows_per_tile - 1) / rows_per_tile, clusters};
  return (int)launch_bwd(p, cluster, stream);
}

// How many clusters of `cluster` CTAs the card keeps resident at once for
// hidden size H; minus the cudaError_t if it refuses the cluster.
extern "C" int bilstm_train_bwd_active_clusters(int H, int cluster, int units) {
  int count = 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure_bwd(H, cluster, units, &cfg, attr);
  cfg.gridDim = dim3(cluster);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&count, bwd_kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// The dynamic shared memory per CTA the kernel launches with.
extern "C" int bilstm_train_bwd_smem_bytes(int H, int cluster, int units) {
  return bwd_smem_bytes(H, cluster * units);
}
