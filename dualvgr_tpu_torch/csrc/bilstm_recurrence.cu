// Bidirectional LSTM recurrence over precomputed input projections, fp32
// arithmetic over fp32 or bf16 gates.
//
// Replaces the TPU kernel dualvgr_tpu/ops/lstm_pallas.py::bilstm_pallas
// (kernel body `_kernel`). Same contract: xf (T, R, 4H) forward gates,
// xb (T, R, 4H) backward gates already time-reversed, W_hh (H, 4H) per
// direction, gate order i, f, g, o, optional packed lengths, optional
// zero-masked per-step outputs (R, T, 2H) and the final state (R, 2H) =
// [h_fwd at len-1, h_bwd at t=0]. The gates are fp32, or bf16 under
// compute_dtype: bfloat16 (lstm_pallas.py:71-72): they are read as bf16 and
// widened, the recurrence runs in fp32, and final and outs are written in
// the gates' dtype (lstm_pallas.py:155-158), rounded to nearest even. W_hh
// and the state are fp32 in both.
//
// Design. On the TPU the grid is (row_blocks, T) and h/c live in VMEM
// scratch across the sequential T axis. Here each row's state depends only
// on that row, so one block owns a tile of kRows rows and one direction
// (blockIdx.y) and loops over T itself; no grid-wide sync is needed. h and
// c of the tile live in shared memory. Per step the block computes the
// (kRows x H) @ (H x 4H) recurrent product: each thread owns
// kRowsPerThread rows x kUnitsPerThread hidden units x the 4 gates of those
// units, so it can apply the cell update to its own (row, unit) pairs with
// no exchange besides the new h.
//
// Bound on the H100. The recurrent product is fp32 FMA work on the CUDA
// cores (no TF32): 2*T*R*H*4H*2 flops, about 155 GFLOP for the appearance
// encoder (T=16, R=4096, H=384), against 67 TFLOP/s; the gate bytes are an
// order of magnitude below that line. W_hh for one direction is
// 384 x 1536 fp32 = 2.36 MB, far above a block's 227 KB of shared memory,
// so it is streamed from L2 through L1 in k order on every step. Each W
// value a thread loads feeds kRowsPerThread FMAs, and the kTy row groups
// of a block share it through L1; the tile shape is chosen from R and the
// SM count at launch (below). Rows past R (the ragged edge) run on zeros
// and are never stored; the TPU pads them instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 128;                        // hidden-unit lanes
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
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// kTy row groups of kRowsPerThread rows: a block owns kTy * kRowsPerThread
// rows and runs kTx * kTy threads.
template <int kTy, int kRowsPerThread, typename TG>
__global__ void __launch_bounds__(kTx * kTy, 1)
bilstm_recurrence_kernel(const TG* __restrict__ xf, const TG* __restrict__ xb,
                         const float* __restrict__ whf, const float* __restrict__ whb,
                         const int* __restrict__ lengths, TG* __restrict__ final_out,
                         TG* __restrict__ outs, int T, int R, int H) {
  constexpr int kThreads = kTx * kTy;
  constexpr int kRows = kTy * kRowsPerThread;
  extern __shared__ float4 smem4[];
  float* sh = reinterpret_cast<float*>(smem4);  // [kRows][H] h state
  float* sc = sh + kRows * H;                   // [kRows][H] c state

  const int dir = blockIdx.y;
  const TG* __restrict__ x = dir ? xb : xf;
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
          store_as(outs + ((size_t)row[r] * T + tt) * 2 * H + dir * H + unit[u], valid ? h : 0.f);
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
      store_as(final_out + (size_t)row[r] * 2 * H + dir * H + unit[u],
               sh[(ty * kRowsPerThread + r) * H + unit[u]]);
    }
  }
}

template <int kTy, int kRowsPerThread, typename TG>
cudaError_t launch(const TG* xf, const TG* xb, const float* whf, const float* whb,
                   const int* lengths, TG* final_out, TG* outs, int T, int R, int H,
                   cudaStream_t stream) {
  constexpr int kRows = kTy * kRowsPerThread;
  auto* kernel = bilstm_recurrence_kernel<kTy, kRowsPerThread, TG>;
  const int smem = 2 * kRows * H * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + kRows - 1) / kRows, 2);
  kernel<<<grid, kTx * kTy, smem, stream>>>(xf, xb, whf, whb, lengths, final_out, outs, T, R, H);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t launch_tiles(const void* xf, const void* xb, const void* whf, const void* whb,
                         const void* lengths, void* final_out, void* outs, int T, int R, int H,
                         int sms, void* stream) {
  const auto* a = static_cast<const TG*>(xf);
  const auto* b = static_cast<const TG*>(xb);
  const auto* wf = static_cast<const float*>(whf);
  const auto* wb = static_cast<const float*>(whb);
  const auto* len = static_cast<const int*>(lengths);
  auto* fin = static_cast<TG*>(final_out);
  auto* o = static_cast<TG*>(outs);
  const auto st = static_cast<cudaStream_t>(stream);
  if (2 * ((R + 15) / 16) >= sms) return launch<2, 8>(a, b, wf, wb, len, fin, o, T, R, H, st);
  return launch<4, 1>(a, b, wf, wb, len, fin, o, T, R, H, st);
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `outs` may be null.
// gate_dtype: 0 for fp32 gates, final and outs; 1 for bf16. Returns the
// cudaError_t of the launch (0 = cudaSuccess).
//
// Tile choice. 16-row tiles of 8 rows per thread feed every W value loaded
// to 8 FMAs; they are used when they give at least one block per SM (the
// appearance encoder, R = 4096 -> 512 blocks). Otherwise (the question
// encoders, R = 256 -> 32 blocks) 4-row tiles of one row per thread spread
// the recurrence over 4x as many SMs.
extern "C" int bilstm_recurrence_launch(const void* xf, const void* xb, const void* whf,
                                        const void* whb, const void* lengths, void* final_out,
                                        void* outs, int T, int R, int H, int gate_dtype,
                                        void* stream) {
  if (T <= 0 || R <= 0 || H <= 0 || H > kMaxHidden || H % 4 != 0 || (gate_dtype != 0 && gate_dtype != 1))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (gate_dtype == 1)
    err = launch_tiles<__nv_bfloat16>(xf, xb, whf, whb, lengths, final_out, outs, T, R, H, sms, stream);
  else
    err = launch_tiles<float>(xf, xb, whf, whb, lengths, final_out, outs, T, R, H, sms, stream);
  return (int)err;
}
