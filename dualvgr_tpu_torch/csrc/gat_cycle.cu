// One DualVGR graph-reasoning cycle for one visual stream, fp32.
//
// Replaces the TPU kernel dualvgr_tpu/ops/gat_pallas.py::fused_gat_cycle
// (kernel body `_cycle_kernel`, GAT body `_gat_block`). For h (B, N, D):
//
//   common = PunishGAT_c(h, scores)   H heads, punished values, ELU
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
// What bounds it on the H100. The four D x D products (x @ Wc, x @ Ws,
// common @ P, spec @ P) are 8 B N D^2 flops, 19.3 GFLOP at B = 256, N = 16,
// D = 768, fp32 on the CUDA cores (67 TFLOP/s): operations bound it, not its
// ~60 MB of inputs and outputs. The earlier design ran one block per video
// and re-read the three 2.36 MB weights from L2 for every video's 16 rows.
//
// Design. A thread-block cluster of `cluster` CTAs takes a tile of videos
// (cluster c of `clusters` takes videos [c B / clusters, (c + 1) B /
// clusters), up to kMaxRows rows); CTA `rank` owns the whole heads
// [rank * hpc, (rank + 1) * hpc), that is the cw = hpc * hd output columns
// [rank * cw, (rank + 1) * cw) of every product (one head of 192 columns at
// the flagship). So a GAT's logits, softmax, punishment, aggregation and ELU
// stay inside the CTA. Each product streams k-chunks of kKC rows of the
// weight's column slice, and the matching kKC columns of the tile's rows of
// A, into a kStages ring in shared memory (cp.async: no registers, the next
// chunk in flight while this one computes); every weight chunk serves all
// the tile's rows, so the L2 reads of the weights fall by the videos a tile
// holds. The products are fp32 FMAs on the CUDA cores: a thread holds TM
// rows x kTN columns in registers (TM of 4 to 8, as the plan fits the tile
// to the 16 row lanes; 12 columns), as CUTLASS's SIMT GEMMs hold a tile,
// reading TM / 4 float4 of A and 3 float4 of W from shared memory for
// 12 TM FMAs a k. A tile of few rows splits each chunk's k range over `ks`
// thread groups (summed in group order through shared memory), so every
// warp works at the serving batch too. No TF32 and no library call.
//
// The GAT's Wh and then its output stay in shared memory, [rows][cw + 4];
// the aggregation overwrites Wh in place, a (video, column) per thread. The
// CTA writes its slice of common and of spec to the outputs as soon as they
// are done. AttentionSFGCN needs whole rows of common and spec: after a
// cluster barrier (release and acquire at cluster scope, after a fence)
// each CTA reads the tile's rows of both from device memory (L2) as the A
// of its own products with its column slice of P, reduces tanh(.) w over
// its columns into a partial score per row, and after a second barrier
// sums the cluster's partials in CTA order through distributed shared
// memory (no atomics: two launches give the same bits). Then it writes out
// for its own columns. A cluster barrier precedes the exit, so no CTA reads
// the shared memory of one that has finished.
//
// What bounds it now (bench/gat_kernel_ab.py's timing-only cuts, H100, B =
// 256, N = 16, clusters of 2 CTAs, 4 videos a cluster, one wave on the 132
// SMs): the products take 82% of a launch and their FMAs run at about 43%
// of the fp32 rate (8 warps an SM, each issuing an FFMA about one cycle in
// five, beside TM + 12 float4 shared-memory loads every 48 TM FMAs); the
// chunks' streaming, without FMAs, would take a quarter of the launch and
// mostly hides behind them; the attention takes 8%, the exchange of partial
// scores under 1%. An H100 keeps 30 clusters of 4 resident (120 SMs), 66
// of 2: the plan weighs rounds of resident clusters against the rows a
// thread holds.
//
// The launch plan (cluster, clusters, column lanes, rows a thread holds) is
// computed in Python, ops/gat_kernel.py::cycle_plan, which the CPU tests
// cover; the C entry refuses a plan this build cannot run and exports its
// shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMinTM = 4, kMaxTM = 8;  // rows a thread holds in a product (the plan's tile_rows)
constexpr int kTN = 12;                 // columns a thread holds in a product
constexpr int kKC = 32;                 // k-chunk depth
constexpr int kAStride = kKC + 4;       // row stride of the A chunks
constexpr int kStages = 2;              // chunks in the ring
constexpr int kMaxRows = 128;           // rows of a tile (videos x N, padded to TM)
constexpr int kMaxColLanes = 16;
constexpr int kMaxNodes = 20;
constexpr int kMaxDim = 768;
constexpr int kMaxCluster = 8;
constexpr int kSmemLimit = 232448;

struct Gat {
  const float* w;       // (D, H*hd), heads merged along columns
  const float* b;       // (H*hd,)
  const float* a;       // (H, 2*hd): [a_src | a_dst] per head
  const float* a_bias;  // (H,)
};

// The tiles of one launch: B videos of N nodes, width D, H heads of hd; a
// cluster of `cluster` CTAs, each owning hpc heads = cw columns; `clusters`
// clusters of at most tb videos, m8 rows padded to tm (rlu row lanes of tm
// rows); the product's threads are rl row lanes x cl column lanes, passes
// column windows of cl * kTN, the k range split over ks groups of rlu row
// lanes, whose partial sums need a ring of `ring` rows; the GAT's rows of
// cstride floats, weight chunk rows of wstride, attention rows of np.
struct Shape {
  int B, N, D, H, hd, cluster, hpc, cw, clusters, tb, tm, cl, rl, passes, m8, rlu, ks, ring, cstride, wstride, np;
};

__host__ __device__ inline Shape make_shape(int B, int N, int D, int H, int cluster, int clusters, int cl, int tm) {
  Shape s;
  s.B = B, s.N = N, s.D = D, s.H = H, s.hd = D / H, s.cluster = cluster, s.hpc = H / cluster, s.cw = D / cluster;
  s.clusters = clusters, s.tb = (B + clusters - 1) / clusters;
  s.tm = tm, s.cl = cl, s.rl = kThreads / cl;
  s.passes = (s.cw + cl * kTN - 1) / (cl * kTN);
  s.m8 = (s.tb * N + tm - 1) / tm * tm;
  s.rlu = s.m8 / tm;
  s.ks = 1;  // the most groups (a power of 2) whose row lanes fit, each with 4 k or more of a chunk
  while (2 * s.ks * s.rlu <= s.rl && 8 * s.ks <= kKC) s.ks *= 2;
  s.ring = kStages * kKC > (s.ks - 1) * s.m8 ? kStages * kKC : (s.ks - 1) * s.m8;
  s.cstride = s.cw + 4;
  s.wstride = cl * kTN;
  s.np = (N + 3) / 4 * 4;
  return s;
}

// Dynamic shared memory of one CTA: the weight ring [kStages][kKC][wstride]
// in a region of `ring` rows (the K split's and the score's partial sums
// reuse it), the A ring [kStages][m8][kAStride], the GAT's rows
// [m8][cstride], the attention [tb][hpc][N][np], the logit halves
// [2][hpc][m8], the partial scores [2][m8] and beta [m8].
__host__ __device__ inline int smem_bytes(const Shape& s) {
  return 4 * (s.ring * s.wstride + kStages * s.m8 * kAStride + s.m8 * s.cstride + 2 * s.hpc * s.m8 +
              s.tb * s.hpc * s.N * s.np + 3 * s.m8);
}

struct Params {
  const float* h;
  const float* scores;
  long long s_b, s_n, s_k;
  Gat gc, gs;
  const float* proj_w;
  const float* proj_b;
  const float* score_w;
  float* out;
  float* common;
  float* spec;
  Shape s;
};

struct Smem {
  float* ws;    // [kStages][kKC][wstride], in a region of `ring` rows
  float* as;    // [kStages][m8][kAStride]
  float* b;     // [m8][cstride]: Wh of the running GAT, then its output
  float* attn;  // [tb][hpc][N][np]
  float* src;   // [hpc][m8]
  float* dst;   // [hpc][m8]
  float* part;  // [2][m8]: the CTA's partial scores of common and spec
  float* beta;  // [m8]
};

// The product's lanes of this thread: K group g, rows rl * TM + i and
// columns cl * kTN + j of the pass's window; `on` if it takes part, `lead`
// if it also holds the sums (group 0).
struct Lane {
  int g, rl, cl;
  bool on, lead;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// 16 bytes, or zeros where `bytes` is 0 (src must still be a valid address).
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// `p` (this CTA's shared memory) in CTA `rank` of the cluster.
__device__ __forceinline__ float* remote(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}

// acc = A[0:m8, :] @ W[:, wcol : wcol + pw] for this thread's rows and
// columns (on the lead threads; the K groups' partial sums added in group
// order). A: `rows` rows of D in device memory, read through L2 (the
// SFGCN's A was written by this launch); rows past `rows` are zeros. Ends
// on a barrier, so the rings are free when it returns.
template <int TM>
__device__ void product(const Shape& s, const Smem& sm, const Lane& ln, const float* A, int rows,
                        const float* __restrict__ W, int wcol, int pw, float (&acc)[TM][kTN]) {
  const int tid = threadIdx.x;
  const int D = s.D;
  const int nchunks = (D + kKC - 1) / kKC;
  const int q4 = pw / 4;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // chunk j of W and of A into ring slot j % kStages, one commit group
  auto issue = [&](int j) {
    if (j < nchunks) {
      const int off = j * kKC, kc = min(kKC, D - off);
      const float* src = W + (size_t)off * D + wcol;
      float* dst = sm.ws + (j % kStages) * kKC * s.wstride;
      for (int idx = tid; idx < kc * q4; idx += kThreads) {
        const int r = idx / q4, q = idx - r * q4;
        cp_async16(dst + r * s.wstride + 4 * q, src + (size_t)r * D + 4 * q);
      }
      float* adst = sm.as + (j % kStages) * s.m8 * kAStride;
      for (int idx = tid; idx < s.m8 * (kKC / 4); idx += kThreads) {
        const int m = idx / (kKC / 4), q = idx % (kKC / 4);
        if (4 * q < kc) {
          const bool in = m < rows;
          cp_async16_or_zero(adst + m * kAStride + 4 * q, A + (size_t)(in ? m : 0) * D + off + 4 * q, in ? 16 : 0);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  auto compute = [&](int slot, int kc) {
    // this group's share of the chunk, in steps of 4
    const int per = (kc + 4 * s.ks - 1) / (4 * s.ks) * 4;
    const int k0 = min(kc, ln.g * per), k1 = min(kc, k0 + per);
    const float* a = sm.as + slot * s.m8 * kAStride + ln.rl * TM * kAStride;
    const float* w = sm.ws + slot * kKC * s.wstride + ln.cl * kTN;
    for (int k = k0; k < k1; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = *reinterpret_cast<const float4*>(a + i * kAStride + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = w + (k + kk) * s.wstride;
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
        const float4 w2 = *reinterpret_cast<const float4*>(wr + 8);
        const float wv[kTN] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y, w2.z, w2.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float x = lane4(av[i], kk);
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(x, wv[j], acc[i][j]);
        }
      }
    }
  };

  for (int j = 0; j < kStages - 1; ++j) issue(j);
  for (int j = 0; j < nchunks; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk j have landed
    __syncthreads();               // everyone's have, and chunk j - 1 is read
    issue(j + kStages - 1);        // into the slot chunk j - 1 used
    if (ln.on) compute(j % kStages, min(kKC, D - j * kKC));
  }
  cp_async_wait<0>();
  __syncthreads();
  if (s.ks > 1) {
    // groups 1.. leave their partial sums in the ring; group 0 adds them in order
    float* red = sm.ws;  // [ks - 1][m8][wstride]
    if (ln.on && ln.g > 0) {
      float* dst = red + ((ln.g - 1) * s.m8 + ln.rl * TM) * s.wstride + ln.cl * kTN;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; j += 4)
          *reinterpret_cast<float4*>(dst + i * s.wstride + j) =
              make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
    }
    __syncthreads();
    if (ln.lead) {
      for (int g = 1; g < s.ks; ++g) {
        const float* src = red + ((g - 1) * s.m8 + ln.rl * TM) * s.wstride + ln.cl * kTN;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + i * s.wstride + j);
            acc[i][j] += v.x, acc[i][j + 1] += v.y, acc[i][j + 2] += v.z, acc[i][j + 3] += v.w;
          }
      }
    }
    __syncthreads();
  }
}

// The attention of one GAT over the tile's tbr videos, on Wh in sm.b (bias
// added): the logit halves, the softmax over all N neighbours, then in
// place b[i] = ELU(sum_j attn_ij * Wh_j * score_j). The logits see Wh
// unpunished, as on the TPU.
__device__ void attention(const Params& p, const Shape& s, const Smem& sm, const Gat& g, int v0, int tbr,
                          int h0) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int N = s.N, hd = s.hd, hpc = s.hpc, M = tbr * N;
  float* B = sm.b;
  for (int task = warp; task < hpc * M; task += kThreads / 32) {
    const int hl = task / M, m = task - hl * M;
    const float* av = g.a + (size_t)(h0 + hl) * 2 * hd;
    const float* wv = B + m * s.cstride + hl * hd;
    float e_src = 0.f, e_dst = 0.f;
    for (int k = lane; k < hd; k += 32) {
      const float w = wv[k];
      e_src = fmaf(__ldg(av + k), w, e_src);
      e_dst = fmaf(__ldg(av + hd + k), w, e_dst);
    }
    e_src = warp_sum(e_src);
    e_dst = warp_sum(e_dst);
    if (lane == 0) {
      sm.src[hl * s.m8 + m] = e_src;
      sm.dst[hl * s.m8 + m] = e_dst;
    }
  }
  __syncthreads();

  for (int task = tid; task < tbr * hpc * N; task += kThreads) {
    const int v = task / (hpc * N), r = task - v * hpc * N;
    const int hl = r / N, i = r - hl * N;
    const float si = sm.src[hl * s.m8 + v * N + i] + __ldg(g.a_bias + h0 + hl);
    const float* dj = sm.dst + hl * s.m8 + v * N;
    float e[kMaxNodes];
    float mx = -3.4e38f;
#pragma unroll
    for (int j = 0; j < kMaxNodes; ++j) {
      if (j >= N) continue;
      float val = si + dj[j];
      val = val >= 0.f ? val : 0.01f * val;
      e[j] = val;
      mx = fmaxf(mx, val);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxNodes; ++j) {
      if (j >= N) continue;
      e[j] = expf(e[j] - mx);
      sum += e[j];
    }
    float* at = sm.attn + ((v * hpc + hl) * N + i) * s.np;
#pragma unroll
    for (int j = 0; j < kMaxNodes; ++j)
      if (j < s.np) at[j] = j < N ? e[j] / sum : 0.f;  // zeros up to the padded row
  }
  __syncthreads();

  for (int task = tid; task < tbr * s.cw; task += kThreads) {
    const int v = task / s.cw, c = task - v * s.cw;
    const int hl = c / hd, k = c - hl * hd;
    const float* sc = p.scores + (v0 + v) * p.s_b + k * p.s_k;
    float* col = B + v * N * s.cstride + c;
    float val[kMaxNodes];
#pragma unroll
    for (int j = 0; j < kMaxNodes; ++j) val[j] = j < N ? col[j * s.cstride] * __ldg(sc + j * p.s_n) : 0.f;
    const float* at = sm.attn + (v * hpc + hl) * N * s.np;
    for (int i = 0; i < N; ++i) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxNodes; j += 4) {
        if (j >= s.np) continue;
        const float4 w = *reinterpret_cast<const float4*>(at + i * s.np + j);
        a = fmaf(w.x, val[j], a);
        a = fmaf(w.y, val[j + 1], a);
        a = fmaf(w.z, val[j + 2], a);
        a = fmaf(w.w, val[j + 3], a);
      }
      col[i * s.cstride] = a > 0.f ? a : expf(a) - 1.f;  // ELU
    }
  }
  __syncthreads();
}

// One punished GAT over the tile into sm.b: Wh = x @ W[:, own columns] + b,
// pass by pass, then the attention; then the CTA's slice goes to `out`.
template <int TM>
__device__ void gat(const Params& p, const Shape& s, const Smem& sm, const Lane& ln, const Gat& g, int v0, int tbr,
                    int rank, float* out) {
  const int c0 = rank * s.cw;
  for (int pass = 0; pass < s.passes; ++pass) {
    const int colbase = pass * s.cl * kTN, pw = min(s.cl * kTN, s.cw - colbase);
    float acc[TM][kTN];
    product<TM>(s, sm, ln, p.h + (size_t)v0 * s.N * s.D, tbr * s.N, g.w, c0 + colbase, pw, acc);
    if (ln.lead) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = colbase + ln.cl * kTN + j;
        if (col >= s.cw) continue;
        const float bias = __ldg(g.b + c0 + col);
#pragma unroll
        for (int i = 0; i < TM; ++i) sm.b[(ln.rl * TM + i) * s.cstride + col] = acc[i][j] + bias;
      }
    }
  }
  __syncthreads();
  attention(p, s, sm, g, v0, tbr, rank * s.hpc);
  const int q4 = s.cw / 4;
  for (int idx = threadIdx.x; idx < tbr * s.N * q4; idx += kThreads) {
    const int m = idx / q4, q = idx - m * q4;
    *reinterpret_cast<float4*>(out + ((size_t)v0 * s.N + m) * s.D + c0 + 4 * q) =
        *reinterpret_cast<const float4*>(sm.b + m * s.cstride + 4 * q);
  }
}

// This CTA's share of s(Z) for every row of the tile: sum over its columns
// c of tanh(Z @ P[:, c] + p[c]) * w[c]; Z: the tile's whole rows of common
// or spec, which every CTA of the cluster wrote a slice of.
template <int TM>
__device__ void sfgcn_partial(const Params& p, const Shape& s, const Smem& sm, const Lane& ln, const float* Z,
                              int M, int rank, float* part) {
  const int c0 = rank * s.cw;
  float t[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) t[i] = 0.f;
  for (int pass = 0; pass < s.passes; ++pass) {
    const int colbase = pass * s.cl * kTN, pw = min(s.cl * kTN, s.cw - colbase);
    float acc[TM][kTN];
    product<TM>(s, sm, ln, Z, M, p.proj_w, c0 + colbase, pw, acc);
    if (ln.lead) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = colbase + ln.cl * kTN + j;
        if (col >= s.cw) continue;
        const float bias = __ldg(p.proj_b + c0 + col), wv = __ldg(p.score_w + c0 + col);
#pragma unroll
        for (int i = 0; i < TM; ++i) t[i] = fmaf(tanhf(acc[i][j] + bias), wv, t[i]);
      }
    }
  }
  // the column lanes' sums per row, in lane order (the ring is free: the
  // product ended on a barrier)
  float* red = sm.ws;  // [m8][cl]
  if (ln.lead) {
#pragma unroll
    for (int i = 0; i < TM; ++i) red[(ln.rl * TM + i) * s.cl + ln.cl] = t[i];
  }
  __syncthreads();
  if ((int)threadIdx.x < s.m8) {
    float v = 0.f;
    for (int c = 0; c < s.cl; ++c) v += red[threadIdx.x * s.cl + c];
    part[threadIdx.x] = v;
  }
  __syncthreads();
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 1) gat_cycle_kernel(const __grid_constant__ Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const Shape& s = p.s;
  const int rank = (int)cluster.block_rank();
  const int cid = (int)(blockIdx.x / s.cluster);
  const int v0 = (int)((long long)cid * s.B / s.clusters);
  const int tbr = (int)((long long)(cid + 1) * s.B / s.clusters) - v0;  // the videos of this tile
  const int M = tbr * s.N;
  const int c0 = rank * s.cw;

  extern __shared__ float4 smem4[];
  Smem sm;
  sm.ws = reinterpret_cast<float*>(smem4);
  sm.as = sm.ws + s.ring * s.wstride;
  sm.b = sm.as + kStages * s.m8 * kAStride;
  sm.attn = sm.b + s.m8 * s.cstride;  // read as float4: every offset before it is a multiple of 4
  sm.src = sm.attn + s.tb * s.hpc * s.N * s.np;
  sm.dst = sm.src + s.hpc * s.m8;
  sm.part = sm.dst + s.hpc * s.m8;
  sm.beta = sm.part + 2 * s.m8;

  Lane ln;
  ln.cl = (int)threadIdx.x % s.cl;
  const int r = (int)threadIdx.x / s.cl;
  ln.g = r / s.rlu;
  ln.rl = r - ln.g * s.rlu;
  ln.on = ln.g < s.ks;
  ln.lead = ln.g == 0;

  gat<TM>(p, s, sm, ln, p.gc, v0, tbr, rank, p.common);
  gat<TM>(p, s, sm, ln, p.gs, v0, tbr, rank, p.spec);  // sm.b keeps spec
  __threadfence();
  cluster.sync();  // every CTA's slices of common and spec are written and visible
  const size_t row0 = (size_t)v0 * s.N * s.D;
  sfgcn_partial<TM>(p, s, sm, ln, p.common + row0, M, rank, sm.part);
  sfgcn_partial<TM>(p, s, sm, ln, p.spec + row0, M, rank, sm.part + s.m8);
  cluster.sync();  // every CTA's partial scores are complete
  if ((int)threadIdx.x < M) {
    float sc = 0.f, ss = 0.f;
    for (int r = 0; r < s.cluster; ++r) {
      const float* rp = remote(sm.part, r);
      sc += rp[threadIdx.x];
      ss += rp[s.m8 + threadIdx.x];
    }
    sm.beta[threadIdx.x] = 1.f / (1.f + expf(-(sc - ss)));
  }
  cluster.sync();  // no CTA reads another's shared memory past here; beta is complete

  const int q4 = s.cw / 4;
  for (int idx = threadIdx.x; idx < M * q4; idx += kThreads) {
    const int m = idx / q4, q = idx - m * q4;
    const size_t g = row0 + (size_t)m * s.D + c0 + 4 * q;
    const float4 x = __ldg(reinterpret_cast<const float4*>(p.h + g));
    const float4 c = __ldcg(reinterpret_cast<const float4*>(p.common + g));
    const float4 v = *reinterpret_cast<const float4*>(sm.b + m * s.cstride + 4 * q);
    const float beta = sm.beta[m], rest = 1.f - beta;
    *reinterpret_cast<float4*>(p.out + g) = make_float4(x.x + (beta * c.x + rest * v.x), x.y + (beta * c.y + rest * v.y),
                                                        x.z + (beta * c.z + rest * v.z), x.w + (beta * c.w + rest * v.w));
  }
}

// The plan's numbers, checked against this build.
bool shape_ok(int B, int N, int D, int H, int cluster, int clusters, int cl, int tm) {
  if (B <= 0 || N <= 0 || N > kMaxNodes || D <= 0 || D > kMaxDim || D % 4 != 0 || H <= 0 || D % H != 0)
    return false;
  if (cluster < 1 || cluster > kMaxCluster || H % cluster != 0 || (D / cluster) % 4 != 0) return false;
  if (cl < 1 || cl > kMaxColLanes || clusters < 1 || clusters > B || tm < kMinTM || tm > kMaxTM) return false;
  const Shape s = make_shape(B, N, D, H, cluster, clusters, cl, tm);
  return s.m8 <= kMaxRows && s.rlu * s.ks <= s.rl && smem_bytes(s) <= kSmemLimit;
}

using Kernel = void (*)(Params);

Kernel kernel_for(int tm) {
  switch (tm) {
    case 4: return gat_cycle_kernel<4>;
    case 5: return gat_cycle_kernel<5>;
    case 6: return gat_cycle_kernel<6>;
    case 7: return gat_cycle_kernel<7>;
    default: return gat_cycle_kernel<8>;
  }
}

cudaError_t configure(const Shape& s, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const int smem = smem_bytes(s);
  const cudaError_t err = cudaFuncSetAttribute(kernel_for(s.tm), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = s.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

}  // namespace

// Shared memory per CTA for a plan, by this build's formula; -1 for a plan
// it cannot run.
extern "C" int gat_cycle_smem_bytes(int B, int N, int D, int H, int cluster, int clusters, int col_lanes,
                                    int tile_rows) {
  if (!shape_ok(B, N, D, H, cluster, clusters, col_lanes, tile_rows)) return -1;
  return smem_bytes(make_shape(B, N, D, H, cluster, clusters, col_lanes, tile_rows));
}

// How many clusters of the plan the card keeps resident at once
// (cudaOccupancyMaxActiveClusters); minus the cudaError_t if it refuses.
extern "C" int gat_cycle_active_clusters(int B, int N, int D, int H, int cluster, int clusters, int col_lanes,
                                         int tile_rows) {
  if (!shape_ok(B, N, D, H, cluster, clusters, col_lanes, tile_rows)) return -(int)cudaErrorInvalidValue;
  const Shape s = make_shape(B, N, D, H, cluster, clusters, col_lanes, tile_rows);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(s, &cfg, attr);
  cfg.gridDim = dim3(cluster);
  int count = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&count, kernel_for(s.tm), &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// Plain C entry for ctypes. scores is read as scores[b*s_b + n*s_n + k*s_k]
// (element strides), so a per-clip score broadcast to the head width
// (s_k = 0) needs no copy. h and the three D x D weights are read 16 bytes
// at a time (16-byte aligned). The plan (cluster, clusters, col_lanes,
// tile_rows) comes from ops/gat_kernel.py::cycle_plan. Returns the
// cudaError_t (0 = cudaSuccess; cudaErrorInvalidValue for dims or a plan
// this build cannot run).
extern "C" int gat_cycle_launch(const void* h, const void* scores, long long s_b, long long s_n, long long s_k,
                                const void* wc, const void* bc, const void* ac, const void* ac_bias,
                                const void* ws, const void* bs, const void* as, const void* as_bias,
                                const void* proj_w, const void* proj_b, const void* score_w, void* out,
                                void* common, void* spec, int B, int N, int D, int H, int cluster, int clusters,
                                int col_lanes, int tile_rows, void* stream) {
  if (!shape_ok(B, N, D, H, cluster, clusters, col_lanes, tile_rows)) return (int)cudaErrorInvalidValue;
  Params p;
  p.h = static_cast<const float*>(h);
  p.scores = static_cast<const float*>(scores);
  p.s_b = s_b, p.s_n = s_n, p.s_k = s_k;
  p.gc = Gat{static_cast<const float*>(wc), static_cast<const float*>(bc), static_cast<const float*>(ac),
             static_cast<const float*>(ac_bias)};
  p.gs = Gat{static_cast<const float*>(ws), static_cast<const float*>(bs), static_cast<const float*>(as),
             static_cast<const float*>(as_bias)};
  p.proj_w = static_cast<const float*>(proj_w);
  p.proj_b = static_cast<const float*>(proj_b);
  p.score_w = static_cast<const float*>(score_w);
  p.out = static_cast<float*>(out);
  p.common = static_cast<float*>(common);
  p.spec = static_cast<float*>(spec);
  p.s = make_shape(B, N, D, H, cluster, clusters, col_lanes, tile_rows);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure(p.s, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(cluster * clusters);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, kernel_for(p.s.tm), p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
