// Backward of the bidirectional LSTM recurrence: fp32 arithmetic over fp32 or
// bf16 gates.
//
// Replaces the TPU kernel dualvgr_tpu/ops/lstm_pallas_train.py::_run_bwd_m
// (kernel body `_bwd_kernel_m`). Inputs: the forward's gates xf, xb (T, R, 4H,
// xb time-reversed), W_hh (H, 4H) and its transpose (4H, H) per direction,
// optional packed lengths, the residuals hprev, cprev (T, R, 2H) written by
// bilstm_train_fwd.cu in kernel time, the gradient of the final state
// dfinal (R, 2H) and, for a forward with outputs, of the outputs douts
// (R, T, 2H, backward half in original time order, as the forward writes
// it; null for a final-only forward, and then never read). Output: dxf, dxb
// (T, R, 4H) in kernel time, the gradients of the gate inputs, which are
// the dgates (i, f, g, o). dW_hh = sum_t h_{t-1}^T dgates is left to one
// plain product outside, as the JAX package leaves it to XLA. The gates may
// be bf16 (the appearance op under compute_dtype: bfloat16), read as bf16
// and widened; the dgates are fp32 either way, as in the TPU kernel.
//
// Masked steps. With m the step's mask, h_t = m h~_t + (1 - m) h_{t-1} and
// out_t = m h~_t, so dh~ = m (dh + m dout), dh_{t-1} gains (1 - m)(dh + m dout),
// dc~ = m dc and dc_{t-1} gains (1 - m) dc; the dgates of a masked step are
// exactly zero. The masks in kernel time: forward t < len, backward
// t >= T - len.
//
// Design. The TPU grid walks (row_blocks, T) with time reversed by the index
// maps and carries (dh, dc) in VMEM. Here one block owns a tile of rows and
// one direction (blockIdx.y) and loops over kernel time from T-1 down to 0
// itself; dh and dc of the tile live in shared memory, starting from
// dh = dfinal, dc = 0. Per step the block
//   1. loads h_{t-1} of its rows into shared memory,
//   2. recomputes the gates x[t] + h_{t-1} W_hh with the forward's product
//      (each thread owns rows x hidden units x the 4 gates of those units),
//   3. applies the cell backward to its own (row, unit) pairs and writes the
//      four dgates into a shared (rows x 4H) tile and into dx[t],
//   4. synchronises, and computes dh_{t-1} += dgates W_hh^T, reading
//      W_hh^T (4H, H) so that the unit lanes load neighbouring addresses.
//      Its output (rows x H) is a quarter of the gate product's, so with
//      the gate product's layout a thread would get rows x 3 FMAs per
//      k-step for the same loads. Instead the 4H range is split over
//      kSplit thread groups, each thread kRows2 rows x kUnits2 units of
//      its group's range (8 x 12 in the 16-row tile, the gate product's
//      mix), and the groups add their partial sums into dh in turn, a
//      fixed order. Measured on the H100 at the appearance shape: 22.4 ->
//      17.5 ms against the gate product's layout.
// Two passes over W_hh per step: twice the forward's operations.
//
// Bound on the H100: fp32 FMA work on the CUDA cores (no TF32), 2 x 2 x
// steps x H x 4H x 2 flops over both directions, about 309 GFLOP at the
// appearance shape (T=16, R=4096, H=384), 4.6 ms at 67 TFLOP/s; it moves
// about 2 GB (gates in, dgates out, residuals in), 0.6 ms at 3.35 TB/s, so
// it is bound by operations. W_hh and W_hh^T (2 x 2.36 MB per direction) are
// streamed from L2 on every step. The 16-row tile's dgates take
// 16 x 1536 x 4 B = 98 KB of shared memory, so the dynamic shared memory
// attribute is raised above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 128;  // hidden-unit lanes
constexpr int kUnitsPerThread = 3;
constexpr int kMaxHidden = kTx * kUnitsPerThread;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ float gate_at(const float* p, size_t i) { return __ldg(p + i); }
__device__ __forceinline__ float gate_at(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(__ldg(p + i));
}

template <int kTy, int kRowsPerThread, int kSplit, int kRows2, int kUnits2, int kUnroll2, typename TG>
__global__ void __launch_bounds__(kTx * kTy, 1)
bilstm_train_bwd_kernel(const TG* __restrict__ xf, const TG* __restrict__ xb,
                        const float* __restrict__ whf, const float* __restrict__ whb,
                        const float* __restrict__ whf_t, const float* __restrict__ whb_t,
                        const int* __restrict__ lengths, const float* __restrict__ hprev,
                        const float* __restrict__ cprev, const float* __restrict__ dfinal,
                        const float* __restrict__ douts, float* __restrict__ dxf,
                        float* __restrict__ dxb, int T, int R, int H) {
  constexpr int kThreads = kTx * kTy;
  constexpr int kRows = kTy * kRowsPerThread;
  extern __shared__ float4 smem4[];
  float* shp = reinterpret_cast<float*>(smem4);  // [kRows][H] h_{t-1} of this step
  float* sdh = shp + kRows * H;                  // [kRows][H] dh carry
  float* sdc = sdh + kRows * H;                  // [kRows][H] dc carry
  float* sdg = sdc + kRows * H;                  // [kRows][4H] dgates of this step

  const int dir = blockIdx.y;
  const TG* __restrict__ x = dir ? xb : xf;
  const float* __restrict__ w = dir ? whb : whf;
  const float* __restrict__ wt = dir ? whb_t : whf_t;
  float* __restrict__ dx = dir ? dxb : dxf;
  const int G = 4 * H;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int grow = row0 + i / H;
    sdh[i] = grow < R ? dfinal[(size_t)grow * 2 * H + dir * H + i % H] : 0.f;
    sdc[i] = 0.f;
  }

  int row[kRowsPerThread], len[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    row[r] = row0 + ty * kRowsPerThread + r;
    // rows past R are masked at every step: their dgates are zero, never stored
    len[r] = row[r] < R ? (lengths ? lengths[row[r]] : T) : 0;
  }
  int unit[kUnitsPerThread], col[kUnitsPerThread];
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u) {
    unit[u] = tx + u * kTx;
    col[u] = min(unit[u], H - 1);  // units past H compute on a valid column, never stored
  }

  for (int t = T - 1; t >= 0; --t) {
    for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
      const int grow = row0 + i / H;
      shp[i] = grow < R ? hprev[((size_t)t * R + grow) * 2 * H + dir * H + i % H] : 0.f;
    }
    __syncthreads();  // h_{t-1} in place; every thread is done with the last step's dgates

    // gates = x[t] + h_{t-1} @ W_hh
    float acc[kRowsPerThread][kUnitsPerThread][4];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const size_t base = ((size_t)t * R + min(row[r], R - 1)) * G;
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[r][u][g] = row[r] < R ? gate_at(x, base + g * H + col[u]) : 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < H; k += 4) {
      float4 hv[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        hv[r] = *reinterpret_cast<const float4*>(shp + (ty * kRowsPerThread + r) * H + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wk = w + (size_t)(k + kk) * G;
#pragma unroll
        for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float wv = __ldg(wk + g * H + col[u]);
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r)
              acc[r][u][g] = fmaf(lane_of(hv[r], kk), wv, acc[r][u][g]);
          }
      }
    }

    // the cell backward on this thread's (row, unit) pairs
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float m = (dir ? (t >= T - len[r]) : (t < len[r])) ? 1.f : 0.f;
      const int lr = ty * kRowsPerThread + r;
      const size_t res = ((size_t)t * R + min(row[r], R - 1)) * 2 * H + dir * H;
      const size_t dout_at = ((size_t)min(row[r], R - 1) * T + (dir ? T - 1 - t : t)) * 2 * H + dir * H;
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u) {
        if (unit[u] >= H) continue;
        const int li = lr * H + unit[u];
        const float ig = sigmoid_f(acc[r][u][0]);
        const float fg = sigmoid_f(acc[r][u][1]);
        const float gg = tanhf(acc[r][u][2]);
        const float og = sigmoid_f(acc[r][u][3]);
        const float c_prev = row[r] < R ? cprev[res + unit[u]] : 0.f;
        const float tc = tanhf(fg * c_prev + ig * gg);
        const float dout = (douts != nullptr && row[r] < R) ? douts[dout_at + unit[u]] : 0.f;
        const float dh_tot = sdh[li] + m * dout;
        const float dh = m * dh_tot;
        const float dc_carry = sdc[li];
        const float dc = m * dc_carry + dh * og * (1.f - tc * tc);
        const float d4[4] = {dc * gg * ig * (1.f - ig), dc * c_prev * fg * (1.f - fg),
                             dc * ig * (1.f - gg * gg), dh * tc * og * (1.f - og)};
#pragma unroll
        for (int g = 0; g < 4; ++g) sdg[lr * G + g * H + unit[u]] = d4[g];
        if (row[r] < R) {
          const size_t out = ((size_t)t * R + row[r]) * G + unit[u];
#pragma unroll
          for (int g = 0; g < 4; ++g) dx[out + g * H] = d4[g];
        }
        // the parts that skip the cell; the product below adds dgates W_hh^T
        sdh[li] = (1.f - m) * dh_tot;
        sdc[li] = (1.f - m) * dc_carry + dc * fg;
      }
    }
    __syncthreads();  // the dgates tile is complete

    // dh_{t-1} += dgates @ W_hh^T, the 4H range split over kSplit thread
    // groups: each thread kRows2 rows x kUnits2 units of a quarter of k
    {
      constexpr int kLanesPerRowGroup = kThreads / kSplit / (kRows / kRows2);
      static_assert(kLanesPerRowGroup * kUnits2 == kMaxHidden, "P2 layout must cover the hidden units");
      const int kg = threadIdx.x / (kThreads / kSplit);
      const int in_g = threadIdx.x % (kThreads / kSplit);
      const int rg = in_g / kLanesPerRowGroup;
      const int lane = in_g % kLanesPerRowGroup;
      const int k_len = G / kSplit;
      float acc2[kRows2][kUnits2];
#pragma unroll
      for (int r = 0; r < kRows2; ++r)
#pragma unroll
        for (int u = 0; u < kUnits2; ++u) acc2[r][u] = 0.f;
      const float* sg = sdg + rg * kRows2 * G + kg * k_len;
      const float* wg = wt + (size_t)kg * k_len * H;
#pragma unroll kUnroll2
      for (int k = 0; k < k_len; k += 4) {
        float4 dv[kRows2];
#pragma unroll
        for (int r = 0; r < kRows2; ++r) dv[r] = *reinterpret_cast<const float4*>(sg + r * G + k);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wk = wg + (size_t)(k + kk) * H;
#pragma unroll
          for (int u = 0; u < kUnits2; ++u) {
            const float wv = __ldg(wk + min(lane + u * kLanesPerRowGroup, H - 1));
#pragma unroll
            for (int r = 0; r < kRows2; ++r) acc2[r][u] = fmaf(lane_of(dv[r], kk), wv, acc2[r][u]);
          }
        }
      }
      // the groups add their partial sums in turn: a fixed order
      for (int g = 0; g < kSplit; ++g) {
        if (kg == g) {
#pragma unroll
          for (int r = 0; r < kRows2; ++r)
#pragma unroll
            for (int u = 0; u < kUnits2; ++u) {
              const int unit2 = lane + u * kLanesPerRowGroup;
              if (unit2 < H) sdh[(rg * kRows2 + r) * H + unit2] += acc2[r][u];
            }
        }
        if (g + 1 < kSplit) __syncthreads();
      }
    }
    // the next step's first barrier orders the last group's sdh updates
    // and the reuse of shp and sdg
  }
}

template <int kTy, int kRowsPerThread, int kSplit, int kRows2, int kUnits2, int kUnroll2, typename TG>
cudaError_t launch(const TG* xf, const TG* xb, const float* whf, const float* whb,
                   const float* whf_t, const float* whb_t, const int* lengths,
                   const float* hprev, const float* cprev, const float* dfinal,
                   const float* douts, float* dxf, float* dxb, int T, int R, int H,
                   cudaStream_t stream) {
  constexpr int kRows = kTy * kRowsPerThread;
  auto* kernel = bilstm_train_bwd_kernel<kTy, kRowsPerThread, kSplit, kRows2, kUnits2, kUnroll2, TG>;
  const int smem = 7 * kRows * H * (int)sizeof(float);  // h, dh, dc, and 4H of dgates
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kRows - 1) / kRows, 2);
  kernel<<<grid, kTx * kTy, smem, stream>>>(xf, xb, whf, whb, whf_t, whb_t, lengths, hprev,
                                            cprev, dfinal, douts, dxf, dxb, T, R, H);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t launch_tiles(const void* xf, const void* xb, const void* whf, const void* whb,
                         const void* whf_t, const void* whb_t, const void* lengths,
                         const void* hprev, const void* cprev, const void* dfinal,
                         const void* douts, void* dxf, void* dxb, int T, int R, int H, int sms,
                         void* stream) {
  const auto* a = static_cast<const TG*>(xf);
  const auto* b = static_cast<const TG*>(xb);
  const auto* wf = static_cast<const float*>(whf);
  const auto* wb = static_cast<const float*>(whb);
  const auto* wtf = static_cast<const float*>(whf_t);
  const auto* wtb = static_cast<const float*>(whb_t);
  const auto* len = static_cast<const int*>(lengths);
  const auto* hp = static_cast<const float*>(hprev);
  const auto* cp = static_cast<const float*>(cprev);
  const auto* dfin = static_cast<const float*>(dfinal);
  const auto* dou = static_cast<const float*>(douts);
  auto* gf = static_cast<float*>(dxf);
  auto* gb = static_cast<float*>(dxb);
  const auto st = static_cast<cudaStream_t>(stream);
  if (2 * ((R + 15) / 16) >= sms)
    return launch<2, 8, 4, 8, 12, 1>(a, b, wf, wb, wtf, wtb, len, hp, cp, dfin, dou, gf, gb, T, R, H, st);
  return launch<4, 1, 4, 4, 3, 4>(a, b, wf, wb, wtf, wtb, len, hp, cp, dfin, dou, gf, gb, T, R, H, st);
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `douts` may be null.
// gate_dtype: 0 for fp32 gates, 1 for bf16. Returns the cudaError_t of the
// launch (0 = cudaSuccess). Tile choice as in
// the forward kernels: 16-row tiles of 8 rows per thread where they give
// every SM a block (the appearance encoder, 172 KB of shared memory at
// H = 384), else 4-row tiles of one row per thread (the question encoders).
// The dh product splits 4H over 4 groups in both: 8 rows x 12 units per
// thread in the 16-row tile; 4 rows x 3 units in the 4-row tile, its loop
// unrolled by 4 to keep several k-steps' loads in flight.
extern "C" int bilstm_train_bwd_launch(const void* xf, const void* xb, const void* whf,
                                       const void* whb, const void* whf_t, const void* whb_t,
                                       const void* lengths, const void* hprev, const void* cprev,
                                       const void* dfinal, const void* douts, void* dxf,
                                       void* dxb, int T, int R, int H, int gate_dtype,
                                       void* stream) {
  if (T <= 0 || R <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 || (gate_dtype != 0 && gate_dtype != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (gate_dtype == 1)
    err = launch_tiles<__nv_bfloat16>(xf, xb, whf, whb, whf_t, whb_t, lengths, hprev, cprev, dfinal, douts,
                                      dxf, dxb, T, R, H, sms, stream);
  else
    err = launch_tiles<float>(xf, xb, whf, whb, whf_t, whb_t, lengths, hprev, cprev, dfinal, douts, dxf,
                              dxb, T, R, H, sms, stream);
  return (int)err;
}
