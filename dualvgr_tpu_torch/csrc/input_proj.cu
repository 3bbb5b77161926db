// The BiLSTM input projection in bf16 on the tensor cores, tanh optionally fused.
//
// Replaces the TPU kernels benchmarks/proj_probe.py::make_pallas_proj (one
// direction, optionally written time-reversed) and ::make_pallas_both (both
// directions from one pass over x, the backward one time-reversed, tanh
// fused or not). Contract, per direction d with weights W_d (G, D) and bias
// b_d (G,), G = 4H:
//
//   out_d[t'] [r, :] = bf16( bf16(f(x[r, t, :])) @ bf16(W_d)^T + b_d )
//
// with f = tanh on fp32 x (the fused form) or the identity on bf16 x, the
// product accumulated in fp32, the fp32 bias added, and one rounding to
// bf16 at the end; t' = t, or T-1-t for a time-reversed direction. x is
// (R, T, D), out_d (T, R, G), time-major: the layout the recurrence kernels
// read. The wrapper (ops/proj_kernel.py) concatenates the directions'
// weights into one (ndir * G, D) bf16 matrix and their biases into one
// (ndir * G,) fp32 vector.
//
// Design. Since x is (R, T, D) contiguous, its R*T rows are the rows of one
// (R*T, D) matrix, so the whole projection is one GEMM of M = R*T rows, N =
// ndir * G columns, K = D; the time-major layout and the reversal live only
// in the epilogue, which maps row m = r*T + t to output row t' * R + r. A
// block computes a 128 x 128 tile with 8 warps, each a 64 x 32 piece as
// 4 x 2 WMMA 16x16x16 bf16 fragments with fp32 accumulators. K runs in steps
// of 32 through two shared-memory stages: the next step's tiles are loaded
// from global memory into registers while the tensor cores work on the
// current one, then tanh'd (fused form), rounded to bf16 and stored into the
// other stage. W's rows are K-contiguous, which is WMMA's column-major B
// layout, so W is read as it lies. The epilogue stages each 16x16
// accumulator through shared memory, adds the bias, rounds once and writes
// 8 bf16 (16 bytes) per lane. Blocks walk the N tiles fastest, so the
// N/128 blocks that share a tile of x run together and read it from L2.
//
// Bound on the H100: 2 * R*T * D * N operations on the tensor cores, 825
// GFLOP for both directions at R = 4096, T = 16, D = 2048, G = 1536: 0.83 ms
// at 989 TFLOP/s, against 0.28 ms for its 952 MB of HBM traffic (x in fp32,
// W, out), so it is bound by operations. The fused form also recomputes
// tanh of each x element once per N tile (24 times for both directions at
// G = 1536): that is CUDA-core work beside the tensor cores' (ROADMAP.md
// and PERF.md weigh it against a separate tanh pass). Later designs: wgmma
// with TMA-fed stages, a persistent schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kLd = kBK + 8;  // bf16 elements per shared row: 80 bytes, fewer bank conflicts
constexpr int kThreads = 256;
constexpr int kWarpM = 64, kWarpN = 32;  // 2 x 4 warps
constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One K step of A: fp32 x, tanh'd and rounded at the store (kTanh), or bf16 x.
template <bool kTanh>
struct ATile;

template <>
struct ATile<true> {
  static constexpr int kVecs = kBM * kBK / 4 / kThreads;  // float4s per thread
  float4 v[kVecs];
  __device__ void load(const void* x, int M, int D, int m0, int k0) {
    const float* xf = static_cast<const float*>(x);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
      const int m = m0 + row, k = k0 + c;
      v[i] = (m < M && k < D) ? __ldg(reinterpret_cast<const float4*>(xf + (size_t)m * D + k))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ void store(__nv_bfloat16* s) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kBK / 4), c = (idx % (kBK / 4)) * 4;
      // accurate tanhf: an approximate tanh would flip bf16 roundings
      uint2 p = make_uint2(pack_bf16(tanhf(v[i].x), tanhf(v[i].y)),
                           pack_bf16(tanhf(v[i].z), tanhf(v[i].w)));
      *reinterpret_cast<uint2*>(s + row * kLd + c) = p;
    }
  }
};

// 8 bf16 per 16-byte vector: the bf16 A tile and the B tile
struct Bf16Tile {
  static constexpr int kVecs = kBM * kBK / 8 / kThreads;
  uint4 v[kVecs];
  __device__ void load(const void* src, int rows, int D, int r0, int k0) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(src);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      const int r = r0 + row, k = k0 + c;
      v[i] = (r < rows && k < D) ? __ldg(reinterpret_cast<const uint4*>(p + (size_t)r * D + k))
                                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ void store(__nv_bfloat16* s) const {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int row = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      *reinterpret_cast<uint4*>(s + row * kLd + c) = v[i];
    }
  }
};

template <>
struct ATile<false> : Bf16Tile {};

template <bool kTanh>
__global__ void __launch_bounds__(kThreads)
input_proj_kernel(const void* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out_f,
                  __nv_bfloat16* __restrict__ out_b, int reverse_f, int reverse_b, int R, int T,
                  int D, int G, int N) {
  __shared__ __align__(128) __nv_bfloat16 sA[2][kBM * kLd];
  __shared__ __align__(128) __nv_bfloat16 sB[2][kBN * kLd];

  const int M = R * T;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / (kBN / kWarpN), wn = warp % (kBN / kWarpN);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFragM][kFragN];
#pragma unroll
  for (int i = 0; i < kFragM; ++i)
#pragma unroll
    for (int j = 0; j < kFragN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  ATile<kTanh> a;
  Bf16Tile b;
  const int k_steps = (D + kBK - 1) / kBK;
  a.load(x, M, D, m0, 0);
  b.load(w, N, D, n0, 0);
  a.store(sA[0]);
  b.store(sB[0]);
  __syncthreads();

  for (int ks = 0; ks < k_steps; ++ks) {
    const int cur = ks & 1;
    const bool more = ks + 1 < k_steps;
    if (more) {  // in flight while the tensor cores work on this step
      a.load(x, M, D, m0, (ks + 1) * kBK);
      b.load(w, N, D, n0, (ks + 1) * kBK);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf[kFragN];
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
        wmma::load_matrix_sync(af[i], sA[cur] + (wm * kWarpM + i * 16) * kLd + kk, kLd);
#pragma unroll
      for (int j = 0; j < kFragN; ++j)
        wmma::load_matrix_sync(bf[j], sB[cur] + (wn * kWarpN + j * 16) * kLd + kk, kLd);
#pragma unroll
      for (int i = 0; i < kFragM; ++i)
#pragma unroll
        for (int j = 0; j < kFragN; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (more) {  // the other stage was last read in the previous step, before its barrier
      a.store(sA[cur ^ 1]);
      b.store(sB[cur ^ 1]);
    }
    __syncthreads();
  }

  // epilogue: each warp stages one 16x16 accumulator at a time in the
  // (now free) A stages; a lane takes 8 columns of one row
  float* stage = reinterpret_cast<float*>(&sA[0][0]) + warp * 256;
  const int lr = lane / 2, lc = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < kFragM; ++i) {
#pragma unroll
    for (int j = 0; j < kFragN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * kWarpM + i * 16 + lr;
      const int n = n0 + wn * kWarpN + j * 16 + lc;
      if (m < M && n < N) {  // G % 8 == 0: the 8 columns lie in one direction
        const int dir = n / G, c = n % G;
        const int r = m / T, t = m % T;
        const int tt = (dir ? reverse_b : reverse_f) ? T - 1 - t : t;
        const float* sv = stage + lr * 16 + lc;
        const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + n));
        const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + n + 4));
        uint4 o;
        o.x = pack_bf16(sv[0] + b0.x, sv[1] + b0.y);
        o.y = pack_bf16(sv[2] + b0.z, sv[3] + b0.w);
        o.z = pack_bf16(sv[4] + b1.x, sv[5] + b1.y);
        o.w = pack_bf16(sv[6] + b1.z, sv[7] + b1.w);
        __nv_bfloat16* dst = dir ? out_b : out_f;
        *reinterpret_cast<uint4*>(dst + ((size_t)tt * R + r) * G + c) = o;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Plain C entry for ctypes. x: (R, T, D), fp32 when x_bf16 == 0 (tanh
// fused) or bf16 when x_bf16 == 1 (taken as it is); w: (ndir * G, D) bf16;
// bias: (ndir * G,) fp32; out_f, out_b: (T, R, G) bf16 (out_b only for
// ndir == 2); reverse_*: 1 writes that direction time-reversed. Needs D % 8
// == 0 and G % 8 == 0 (16-byte vectors) and 16-byte aligned pointers.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int input_proj_launch(const void* x, int x_bf16, const void* w, const void* bias,
                                 void* out_f, void* out_b, int reverse_f, int reverse_b, int R,
                                 int T, int D, int G, int ndir, void* stream) {
  if (R <= 0 || T <= 0 || D <= 0 || G <= 0 || D % 8 || G % 8 || (ndir != 1 && ndir != 2) ||
      (ndir == 2 && out_b == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)R * T;
  const int N = ndir * G;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)((M + kBM - 1) / kBM));
  if (grid.y > 65535u || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* bi = static_cast<const float*>(bias);
  auto* of = static_cast<__nv_bfloat16*>(out_f);
  auto* ob = static_cast<__nv_bfloat16*>(out_b);
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    input_proj_kernel<false><<<grid, kThreads, 0, st>>>(x, wb, bi, of, ob, reverse_f, reverse_b, R, T,
                                                        D, G, N);
  else
    input_proj_kernel<true><<<grid, kThreads, 0, st>>>(x, wb, bi, of, ob, reverse_f, reverse_b, R, T,
                                                       D, G, N);
  return (int)cudaGetLastError();
}
