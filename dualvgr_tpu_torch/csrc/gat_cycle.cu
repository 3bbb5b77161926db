// One DualVGR graph-reasoning cycle for one visual stream, fp32.
//
// Replaces the TPU kernel dualvgr_tpu/ops/gat_pallas.py::fused_gat_cycle
// (kernel body `_cycle_kernel`, GAT body `_gat_block`). For h (B, N, D):
//
//   common = PunishGAT_c(h, scores)   4 heads, punished values, ELU
//   spec   = PunishGAT_s(h, scores)
//   beta   = sigmoid(s(common) - s(spec)),  s(z) = tanh(z @ P + p) @ w
//   out    = h + beta * common + (1 - beta) * spec
//
// and returns (out, common, spec); the auxiliary losses read the last two.
// Per head the N x N attention uses the additive logits
// e_ij = a_src . Wh_i + a_dst . Wh_j + a_bias (LeakyReLU 0.01, softmax over
// j); the dense adjacency of the model is strictly positive, so its mask is
// a no-op and is elided, as on the TPU. The softmax over the [common, spec]
// pair is the sigmoid of the score difference.
//
// Design. One block per video: N <= 20 nodes x D = 768 fp32 is 60 KB per
// tile, so three tiles (x, later spec; Wh of the running GAT; common) sit in
// dynamic shared memory, together with the per-head logits and the N x N
// attention. The four D x D products (x @ Wc, x @ Ws, common @ P, spec @ P)
// are computed in this kernel: each thread owns kCols output columns for
// all NT rows of the tile, reads the tile from shared memory as broadcast
// float4s and streams the weight from L2 in k order. The batch edge needs
// no padding (one block per video); rows from N up to the tile height NT
// are zeros and never stored.
//
// Bound on the H100. The four products are 8*B*N*D*D flops, about 19 GFLOP
// at B=256, N=16, D=768, fp32 on the CUDA cores (67 TFLOP/s): the kernel is
// bound by operations, not by its ~60 MB of inputs and outputs. Each block
// re-reads the 2.36 MB weights from L2 for only N rows; the L2 traffic, not
// device memory, is what a faster version cuts (several videos per block).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 3;                       // output columns per thread
constexpr int kMaxDim = kThreads * kCols;      // 768
constexpr int kMaxNodes = 20;

struct Gat {
  const float* w;       // (D, H*hd), heads merged along columns
  const float* b;       // (H*hd,)
  const float* a;       // (H, 2*hd): [a_src | a_dst] per head
  const float* a_bias;  // (H,)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][m] = sum_k A[i][k] * W[k][col_m], A (NT x D) in shared memory,
// W (D x D) in device memory, col_m = threadIdx.x + m * kThreads.
template <int NT>
__device__ __forceinline__ void tile_matmul(const float* sA, const float* __restrict__ W,
                                            int D, float (&acc)[NT][kCols]) {
  int col[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) col[m] = min((int)threadIdx.x + m * kThreads, D - 1);
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int m = 0; m < kCols; ++m) acc[i][m] = 0.f;
  // the weights of step k + 4 are loaded while step k computes, so the L2
  // latency of the weight stream hides behind the FMAs
  float w[4][kCols];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int m = 0; m < kCols; ++m) w[kk][m] = __ldg(W + (size_t)kk * D + col[m]);
#pragma unroll 1
  for (int k = 0; k < D; k += 4) {
    float wn[4][kCols];
    const int kn = k + 4 < D ? k + 4 : k;  // the last step reloads its own weights
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < kCols; ++m) wn[kk][m] = __ldg(W + (size_t)(kn + kk) * D + col[m]);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(sA + i * D + k);
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        float s = acc[i][m];
        s = fmaf(a.x, w[0][m], s);
        s = fmaf(a.y, w[1][m], s);
        s = fmaf(a.z, w[2][m], s);
        s = fmaf(a.w, w[3][m], s);
        acc[i][m] = s;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < kCols; ++m) w[kk][m] = wn[kk][m];
  }
}

// One punished multi-head GAT: sOut[i] = ELU(sum_j attn_ij * Wh_j * score_j)
// for i < n. sX and sOut may be the same tile: sX is read only by the
// product, before the barriers that precede the write.
template <int NT>
__device__ void gat_block(const float* sX, float* sWh, float* sOut, const Gat p,
                          const float* __restrict__ scores, long long s_n, long long s_k,
                          int n, int D, int H, float* sSrc, float* sDst, float* sAttn) {
  const int tid = threadIdx.x;
  const int hd = D / H;
  {
    float acc[NT][kCols];
    tile_matmul<NT>(sX, p.w, D, acc);
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int col = tid + m * kThreads;
      if (col >= D) continue;
      const float bias = p.b[col];
#pragma unroll
      for (int i = 0; i < NT; ++i) sWh[i * D + col] = acc[i][m] + bias;
    }
  }
  __syncthreads();

  // the two halves of the additive logits, one warp per (half, head, node)
  const int warp = tid / 32, lane = tid % 32;
  for (int task = warp; task < 2 * H * n; task += kWarps) {
    const int half = task / (H * n);
    const int h = (task % (H * n)) / n;
    const int i = task % n;
    const float* av = p.a + h * 2 * hd + half * hd;
    const float* wv = sWh + i * D + h * hd;
    float s = 0.f;
    for (int k = lane; k < hd; k += 32) s = fmaf(av[k], wv[k], s);
    s = warp_sum(s);
    if (lane == 0) (half ? sDst : sSrc)[h * NT + i] = s;
  }
  __syncthreads();

  // softmax over the neighbours j of each (head, node i)
  for (int task = tid; task < H * n; task += kThreads) {
    const int h = task / n, i = task % n;
    float e[NT];
    float mx = -3.4e38f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= n) continue;
      float v = sSrc[h * NT + i] + sDst[h * NT + j] + p.a_bias[h];
      v = v >= 0.f ? v : 0.01f * v;
      e[j] = v;
      mx = fmaxf(mx, v);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= n) continue;
      e[j] = expf(e[j] - mx);
      sum += e[j];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < n) sAttn[(h * NT + i) * NT + j] = e[j] / sum;
  }
  // punishment: the values are gated, the logits above are not
#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    const int col = tid + m * kThreads;
    if (col >= D) continue;
    const int k = col % hd;
    for (int j = 0; j < n; ++j) sWh[j * D + col] *= scores[j * s_n + k * s_k];
  }
  __syncthreads();

#pragma unroll
  for (int m = 0; m < kCols; ++m) {
    const int col = tid + m * kThreads;
    if (col >= D) continue;
    const int h = col / hd;
    float v[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) v[j] = j < n ? sWh[j * D + col] : 0.f;
    for (int i = 0; i < n; ++i) {
      const float* at = sAttn + (h * NT + i) * NT;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (j < n) s = fmaf(at[j], v[j], s);
      sOut[i * D + col] = s > 0.f ? s : expf(s) - 1.f;  // ELU
    }
  }
  __syncthreads();
}

// sScore[i] = tanh(Z_i @ P + p) @ w for i < n (AttentionSFGCN's logit).
template <int NT>
__device__ void sfgcn_score(const float* sZ, const float* __restrict__ P,
                            const float* __restrict__ pb, const float* __restrict__ sw,
                            int n, int D, float* sRed, float* sScore) {
  const int tid = threadIdx.x;
  float part[NT];
  {
    float acc[NT][kCols];
    tile_matmul<NT>(sZ, P, D, acc);
#pragma unroll
    for (int i = 0; i < NT; ++i) part[i] = 0.f;
#pragma unroll
    for (int m = 0; m < kCols; ++m) {
      const int col = tid + m * kThreads;
      if (col >= D) continue;
      const float bias = pb[col], wv = sw[col];
#pragma unroll
      for (int i = 0; i < NT; ++i) part[i] = fmaf(tanhf(acc[i][m] + bias), wv, part[i]);
    }
  }
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const float s = warp_sum(part[i]);
    if (lane == 0) sRed[i * kWarps + warp] = s;
  }
  __syncthreads();
  if (tid < n) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sRed[tid * kWarps + w];
    sScore[tid] = s;
  }
  __syncthreads();
}

// One block per SM at the flagship tile (147 KB of shared memory), so the
// kernel may take all 255 registers a thread can have: at 128 the tile
// product's accumulators spill.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
gat_cycle_kernel(const float* __restrict__ hin, const float* __restrict__ scores,
                 long long s_b, long long s_n, long long s_k, Gat gc, Gat gs,
                 const float* __restrict__ proj_w, const float* __restrict__ proj_b,
                 const float* __restrict__ score_w, float* __restrict__ out,
                 float* __restrict__ common, float* __restrict__ spec, int n, int D, int H) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // x, then spec
  float* sB = sA + NT * D;                      // Wh of the running GAT
  float* sC = sB + NT * D;                      // common
  float* sSrc = sC + NT * D;                    // [H][NT]
  float* sDst = sSrc + H * NT;                  // [H][NT]
  float* sAttn = sDst + H * NT;                 // [H][NT][NT]
  float* sRed = sAttn + H * NT * NT;            // [NT][kWarps]
  float* sScore = sRed + NT * kWarps;           // [2][NT]: common, spec

  const size_t off = (size_t)blockIdx.x * n * D;
  const float* x = hin + off;
  const float* sc = scores + blockIdx.x * s_b;

  for (int idx = threadIdx.x; idx < NT * D; idx += kThreads) {
    sA[idx] = idx < n * D ? x[idx] : 0.f;
    sC[idx] = 0.f;
  }
  __syncthreads();

  gat_block<NT>(sA, sB, sC, gc, sc, s_n, s_k, n, D, H, sSrc, sDst, sAttn);
  gat_block<NT>(sA, sB, sA, gs, sc, s_n, s_k, n, D, H, sSrc, sDst, sAttn);
  sfgcn_score<NT>(sC, proj_w, proj_b, score_w, n, D, sRed, sScore);
  sfgcn_score<NT>(sA, proj_w, proj_b, score_w, n, D, sRed, sScore + NT);

  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int i = idx / D;
    const float beta = 1.f / (1.f + expf(-(sScore[i] - sScore[NT + i])));
    const float c = sC[idx], s = sA[idx];
    out[off + idx] = x[idx] + (beta * c + (1.f - beta) * s);
    common[off + idx] = c;
    spec[off + idx] = s;
  }
}

template <int NT>
cudaError_t launch(dim3 grid, cudaStream_t stream, const float* h, const float* scores,
                   long long s_b, long long s_n, long long s_k, Gat gc, Gat gs,
                   const float* proj_w, const float* proj_b, const float* score_w, float* out,
                   float* common, float* spec, int n, int D, int H) {
  const int smem = (int)sizeof(float) *
                   (3 * NT * D + 2 * H * NT + H * NT * NT + NT * kWarps + 2 * NT);
  cudaError_t err = cudaFuncSetAttribute(
      gat_cycle_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gat_cycle_kernel<NT><<<grid, kThreads, smem, stream>>>(
      h, scores, s_b, s_n, s_k, gc, gs, proj_w, proj_b, score_w, out, common, spec, n, D, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. scores is read as scores[b*s_b + n*s_n + k*s_k]
// (element strides), so a per-clip score broadcast to the head width
// (s_k = 0) needs no copy. Returns the cudaError_t (0 = cudaSuccess).
extern "C" int gat_cycle_launch(const void* h, const void* scores, long long s_b,
                                long long s_n, long long s_k, const void* wc, const void* bc,
                                const void* ac, const void* ac_bias, const void* ws,
                                const void* bs, const void* as, const void* as_bias,
                                const void* proj_w, const void* proj_b, const void* score_w,
                                void* out, void* common, void* spec, int B, int N, int D, int H,
                                void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxNodes || D <= 0 || D > kMaxDim || D % 4 != 0 || H <= 0 ||
      D % H != 0)
    return (int)cudaErrorInvalidValue;
  const Gat gc{static_cast<const float*>(wc), static_cast<const float*>(bc),
               static_cast<const float*>(ac), static_cast<const float*>(ac_bias)};
  const Gat gs{static_cast<const float*>(ws), static_cast<const float*>(bs),
               static_cast<const float*>(as), static_cast<const float*>(as_bias)};
  const auto* hp = static_cast<const float*>(h);
  const auto* sp = static_cast<const float*>(scores);
  const auto* pw = static_cast<const float*>(proj_w);
  const auto* pb = static_cast<const float*>(proj_b);
  const auto* sw = static_cast<const float*>(score_w);
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<float*>(common);
  auto* s = static_cast<float*>(spec);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B);
  cudaError_t err;
  if (N <= 8)
    err = launch<8>(grid, st, hp, sp, s_b, s_n, s_k, gc, gs, pw, pb, sw, o, c, s, N, D, H);
  else if (N <= 16)
    err = launch<16>(grid, st, hp, sp, s_b, s_n, s_k, gc, gs, pw, pb, sw, o, c, s, N, D, H);
  else
    err = launch<20>(grid, st, hp, sp, s_b, s_n, s_k, gc, gs, pw, pb, sw, o, c, s, N, D, H);
  return (int)err;
}
