// Training forward of the bidirectional LSTM recurrence, fp32, with residuals.
//
// Replaces the TPU kernel dualvgr_tpu/ops/lstm_pallas_train.py::_run_fwd_m
// (kernel body `_fwd_kernel_m`). It computes what the eval recurrence
// (bilstm_recurrence.cu) computes: xf (T, R, 4H) forward gates, xb (T, R, 4H)
// backward gates already time-reversed, W_hh (H, 4H) per direction, gate
// order i, f, g, o, optional packed lengths, optional zero-masked per-step
// outputs (R, T, 2H) with the backward half back in original time order,
// final state (R, 2H) = [h_fwd at len-1, h_bwd at t=0]. Besides, it stores
// the state each step starts from, (h_{t-1}, c_{t-1}), into hprev and cprev
// (T, R, 2H) in kernel time, [fwd | bwd] on the last axis: the backward
// kernel (bilstm_train_bwd.cu) recomputes the gates from them and the
// streamed gates, instead of keeping the (T, R, 4H) activations.
//
// Design: the eval kernel's. The TPU grid (row_blocks, T) carries h/c in
// VMEM across the sequential T axis; here each block owns a tile of rows and
// one direction (blockIdx.y) and loops over T itself, h and c of the tile in
// shared memory. Each thread owns kRowsPerThread rows x kUnitsPerThread
// hidden units x the 4 gates of those units, so it applies the cell update
// to its own (row, unit) pairs and stores its own residuals, coalesced
// across the unit lanes, with no exchange besides the new h.
//
// Bound on the H100: the recurrent product is fp32 FMA work on the CUDA
// cores (no TF32), 2 * steps * H * 4H * 2 flops over both directions, about
// 155 GFLOP for the appearance encoder (T=16, R=4096, H=384), 2.3 ms at
// 67 TFLOP/s. The residuals add 2 x 201 MB of stores at that shape, 0.12 ms
// of HBM time, so the kernel stays bound by operations. W_hh (2.36 MB per
// direction) does not fit in shared memory and is streamed from L2 on every
// step, as in the eval kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kTx = 128;  // hidden-unit lanes
constexpr int kUnitsPerThread = 3;
constexpr int kMaxHidden = kTx * kUnitsPerThread;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <int kTy, int kRowsPerThread>
__global__ void __launch_bounds__(kTx * kTy, 1)
bilstm_train_fwd_kernel(const float* __restrict__ xf, const float* __restrict__ xb,
                        const float* __restrict__ whf, const float* __restrict__ whb,
                        const int* __restrict__ lengths, float* __restrict__ final_out,
                        float* __restrict__ outs, float* __restrict__ hprev,
                        float* __restrict__ cprev, int T, int R, int H) {
  constexpr int kThreads = kTx * kTy;
  constexpr int kRows = kTy * kRowsPerThread;
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);  // [kRows][H] h state
  float* sc = sh + kRows * H;                   // [kRows][H] c state

  const int dir = blockIdx.y;
  const float* __restrict__ x = dir ? xb : xf;
  const float* __restrict__ w = dir ? whb : whf;
  const int G = 4 * H;
  const int tx = threadIdx.x % kTx;
  const int ty = threadIdx.x / kTx;
  const int row0 = blockIdx.x * kRows;

  for (int i = threadIdx.x; i < 2 * kRows * H; i += kThreads) sh[i] = 0.f;  // h and c

  int row[kRowsPerThread], len[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    row[r] = row0 + ty * kRowsPerThread + r;
    // rows past R never enter a valid step: they stay at zero and are not stored
    len[r] = row[r] < R ? (lengths ? lengths[row[r]] : T) : 0;
  }
  int unit[kUnitsPerThread], col[kUnitsPerThread];
#pragma unroll
  for (int u = 0; u < kUnitsPerThread; ++u) {
    unit[u] = tx + u * kTx;
    col[u] = min(unit[u], H - 1);  // units past H compute on a valid column, never stored
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // residuals: the state this step starts from, each thread its own pairs
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (row[r] >= R) continue;
      const size_t base = ((size_t)t * R + row[r]) * 2 * H + dir * H;
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u) {
        if (unit[u] >= H) continue;
        const int li = (ty * kRowsPerThread + r) * H + unit[u];
        hprev[base + unit[u]] = sh[li];
        cprev[base + unit[u]] = sc[li];
      }
    }

    float acc[kRowsPerThread][kUnitsPerThread][4];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const size_t base = ((size_t)t * R + min(row[r], R - 1)) * G;
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[r][u][g] = row[r] < R ? __ldg(x + base + g * H + col[u]) : 0.f;
    }

    // gates += h_{t-1} @ W_hh
#pragma unroll 1
    for (int k = 0; k < H; k += 4) {
      float4 hv[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        hv[r] = *reinterpret_cast<const float4*>(sh + (ty * kRowsPerThread + r) * H + k);
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
    __syncthreads();  // every thread has read h_{t-1}

#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      // packed-sequence masks: the forward direction is valid while t < len;
      // the backward one (reversed time) from T - len on, zero before
      const bool valid = dir ? (t >= T - len[r]) : (t < len[r]);
#pragma unroll
      for (int u = 0; u < kUnitsPerThread; ++u) {
        if (unit[u] >= H) continue;
        const int li = (ty * kRowsPerThread + r) * H + unit[u];
        float c = sc[li], h = sh[li];
        if (valid) {
          const float ig = sigmoid_f(acc[r][u][0]);
          const float fg = sigmoid_f(acc[r][u][1]);
          const float gg = tanhf(acc[r][u][2]);
          const float og = sigmoid_f(acc[r][u][3]);
          c = fg * c + ig * gg;
          h = og * tanhf(c);
          sc[li] = c;
          sh[li] = h;
        }
        if (outs != nullptr && row[r] < R) {
          // backward half written back in original time order
          const int tt = dir ? T - 1 - t : t;
          outs[((size_t)row[r] * T + tt) * 2 * H + dir * H + unit[u]] = valid ? h : 0.f;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    if (row[r] >= R) continue;
#pragma unroll
    for (int u = 0; u < kUnitsPerThread; ++u) {
      if (unit[u] >= H) continue;
      final_out[(size_t)row[r] * 2 * H + dir * H + unit[u]] =
          sh[(ty * kRowsPerThread + r) * H + unit[u]];
    }
  }
}

template <int kTy, int kRowsPerThread>
cudaError_t launch(const float* xf, const float* xb, const float* whf, const float* whb,
                   const int* lengths, float* final_out, float* outs, float* hprev,
                   float* cprev, int T, int R, int H, cudaStream_t stream) {
  constexpr int kRows = kTy * kRowsPerThread;
  auto* kernel = bilstm_train_fwd_kernel<kTy, kRowsPerThread>;
  const int smem = 2 * kRows * H * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kRows - 1) / kRows, 2);
  kernel<<<grid, kTx * kTy, smem, stream>>>(xf, xb, whf, whb, lengths, final_out, outs, hprev,
                                            cprev, T, R, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `outs` may be null.
// Returns the cudaError_t of the launch (0 = cudaSuccess). Tile choice as in
// the eval kernel: 16-row tiles of 8 rows per thread where they give every
// SM a block (the appearance encoder), else 4-row tiles of one row per
// thread (the question encoders, R = 256).
extern "C" int bilstm_train_fwd_launch(const void* xf, const void* xb, const void* whf,
                                       const void* whb, const void* lengths, void* final_out,
                                       void* outs, void* hprev, void* cprev, int T, int R, int H,
                                       void* stream) {
  if (T <= 0 || R <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const auto* a = static_cast<const float*>(xf);
  const auto* b = static_cast<const float*>(xb);
  const auto* wf = static_cast<const float*>(whf);
  const auto* wb = static_cast<const float*>(whb);
  const auto* len = static_cast<const int*>(lengths);
  auto* fin = static_cast<float*>(final_out);
  auto* o = static_cast<float*>(outs);
  auto* hp = static_cast<float*>(hprev);
  auto* cp = static_cast<float*>(cprev);
  const auto st = static_cast<cudaStream_t>(stream);
  if (2 * ((R + 15) / 16) >= sms) err = launch<2, 8>(a, b, wf, wb, len, fin, o, hp, cp, T, R, H, st);
  else err = launch<4, 1>(a, b, wf, wb, len, fin, o, hp, cp, T, R, H, st);
  return (int)err;
}
