// Kernel 9: the recurrent weight gradient dW_hh of a trainable BiLSTM in
// fp32 on the tensor cores, as 3xTF32, both directions in one launch.
//
// Replaces no TPU kernel. The JAX package leaves dW_hh to XLA (one einsum a
// direction, dualvgr_tpu/ops/lstm_pallas_train.py:274-277), and the port
// left it to two fp32 library products, cuBLAS's SIMT SGEMM on the FFMA
// pipes. Contract, with kernel 3's pre-step states hprev (T, R, 2H) and
// kernel 4's dgates dxf, dxb (T, R, G), G = 4H, all in kernel time (the
// backward direction's step t is the sequence's step T-1-t in both, so
// they meet as they lie):
//
//   dW_f[h, g] = sum over (t, r) of hprev[t, r, h]     * dxf[t, r, g]
//   dW_b[h, g] = sum over (t, r) of hprev[t, r, H + h] * dxb[t, r, g]
//
// all fp32, each dW (H, G) row-major: the (H, 4H) layout of w_hh^T that the
// BiLSTM's autograd Functions return.
//
// The GEMM: M = 2G (both directions' gates), N = H, K = R*T, on kernel 8's
// skeleton (wgrad_f32.cu), whose 3xTF32, promotion and operands it keeps:
// - A = the dgates from registers, read in place through TMA and
//   transposed on read (tma_gemm.cuh::DgatesReader).
// - B = hprev goes through a pass in the same entry that splits it into its
//   TF32 halves and writes them K-major, (2H, T, R_pad) each, into the
//   wrapper's scratch, zero at r in [R, R_pad); a tile of dW_b reads
//   channels H + n. The pass reads hprev once and writes both halves: 0.6
//   GB at the msrvtt-qa step, 0.27 ms measured (2.2 TB/s).
// - A k-block is 32 rows r of one step t, as in kernel 8; both operands are
//   3-D maps, so TMA zero-fills a ragged R per step.
// - Filling the grid: M = 3,072 and N = 384 give 72 output tiles of 128 x
//   128 at the flagship's H, against 132 SMs, so K is split into ``splits``
//   ranges of whole k-blocks (the wrapper's plan,
//   ops/whh_grad_kernel.py::whh_grad_plan: 11 at 132 SMs, so 792 units of
//   work fill 6 waves). A unit (split s, tile) is s * tiles + tile, tiles
//   fastest, so the units in flight walk the same k-blocks of every tile
//   and read each operand from HBM about once a wave. Each unit stores its
//   fp32 partial tile, 64 KB, from the registers into the wrapper's scratch;
//   a last pass sums the partials of each output element in split order
//   (the same bits on every run) and writes dW transposed, (H, G), through
//   shared memory.
// - Warp specialisation as in kernel 8: one producer thread feeds a ring of
//   4 stages (the dgates, B_hi and B_lo tiles, 48 KB a stage); two consumer
//   warpgroups of 64 gates x 128 columns each; setmaxnreg gives the
//   consumers 232 registers and the producer 40.
//
// Bound on the H100: 2 * R*T * H * 2G operations a product, three products
// on the tensor cores. At the msrvtt-qa train step's appearance BiLSTM (R*T
// = 65,536, H = 384, 2G = 3,072) that is 3 x 155 GFLOP, 0.94 ms at 495
// TFLOP/s, against about 0.4 ms for its bytes (the dgates, hprev and its
// halves once, the partials): bound by operations. The SGEMMs it replaces
// need 2.3 ms at the FFMA pipes' 67 TFLOP/s.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_gemm.cuh"

namespace {

using namespace tma_gemm;

constexpr int kBM = 128, kBN = 128, kBK = kDgK;  // kBK fp32 = 128 bytes: one swizzle row
constexpr int kStages = 4;
static_assert(kBN == 128, "wgmma n128");
constexpr int kAcc = kBN / 2;    // fp32 accumulators a consumer thread
constexpr int kConsumers = 2;    // warpgroups, 64 gates each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 4, kBBytes = kBN * kBK * 4;
constexpr int kStageBytes = kABytes + 2 * kBBytes;  // the dgates, B_hi, B_lo
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can have");
constexpr int kTileFloats = kBM * kBN;  // a unit's partial tile
constexpr int kPassTile = 32, kPassThreads = 256;
constexpr int kMaxSplits = 1024;

struct Params {
  float* partial;  // (units, kBM, kBN): unit u's tile, gate-major
  int R, T, H, G;
  int m_tiles_dir, n_tiles, tiles, splits, units, r_blocks, k_blocks;
};

// Unit u's direction, first gate within the direction, first column and
// k-blocks [kb0, kb1): split s = u / tiles of K, tile u % tiles, 128-gate
// tiles within one direction, N fastest.
__device__ __forceinline__ void unit_origin(int u, const Params& p, int& dir, int& m0, int& n0, int& kb0,
                                            int& kb1) {
  const int s = u / p.tiles, tile = u % p.tiles, mi = tile / p.n_tiles;
  dir = mi >= p.m_tiles_dir;
  m0 = (mi - dir * p.m_tiles_dir) * kBM;
  n0 = (tile % p.n_tiles) * kBN;
  kb0 = (int)((long long)s * p.k_blocks / p.splits);
  kb1 = (int)((long long)(s + 1) * p.k_blocks / p.splits);
}

__global__ void __launch_bounds__(kThreads, 1)
whh_grad_kernel(const __grid_constant__ CUtensorMap map_df, const __grid_constant__ CUtensorMap map_db,
                const __grid_constant__ CUtensorMap map_hi, const __grid_constant__ CUtensorMap map_lo,
                const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // stage s: the dgates tile (four 4 KB boxes), then B_hi, then B_lo
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: k-block (t, r0) of unit (dir, m0, n0) is the dgates' box at
    // (m0 + 32 j, r0, t) and the hprev halves' at (r0, t, dir H + n0)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        int dir, m0, n0, kb0, kb1;
        unit_origin(u, p, dir, m0, n0, kb0, kb1);
        const CUtensorMap* map_a = dir ? &map_db : &map_df;
        const int c0 = dir * p.H + n0;
        int t = kb0 / p.r_blocks, r0 = (kb0 % p.r_blocks) * kBK;
        for (int kb = kb0; kb < kb1; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          uint8_t* s = smem + stage * kStageBytes;
#pragma unroll
          for (int j = 0; j < kBM / kDgSub; ++j)
            tma_load_3d(s + j * kDgSubBytes, map_a, &full[stage], m0 + j * kDgSub, r0, t);
          tma_load_3d(s + kABytes, &map_hi, &full[stage], r0, t, c0);
          tma_load_3d(s + kABytes + kBBytes, &map_lo, &full[stage], r0, t, c0);
          if ((r0 += kBK) >= p.R) r0 = 0, ++t;
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32, q = lane % 4;
    const DgatesReader me(wg, warp, lane);
    int stage = 0;
    uint32_t phase = 0;
    float d[kAcc], acc[kAcc];
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      int dir, m0, n0, kb0, kb1;
      unit_origin(u, p, dir, m0, n0, kb0, kb1);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int kb = kb0; kb < kb1; ++kb) {
        // the k-block: the thread's dgates fragments split, 3 kDgSteps
        // wgmmas into d (the first overwriting it), retired, the stage
        // handed back, and d promoted into acc with fp32 adds
        uint32_t f[kDgSteps][8];
        const uint8_t* s = smem + stage * kStageBytes;
        mbar_wait(&full[stage], phase);
        me.load_split(f, s);
        const uint64_t dhi = smem_desc(s + kABytes), dlo = smem_desc(s + kABytes + kBBytes);
        fence_frags(f);
        fence_operands(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int k = 0; k < kDgSteps; ++k) {  // 8 tf32 = 32 bytes = 2 descriptor units
          wgmma_tf32(d, f[k][4], f[k][5], f[k][6], f[k][7], dhi + 2 * k, k == 0 ? 0 : 1);
          wgmma_tf32(d, f[k][0], f[k][1], f[k][2], f[k][3], dlo + 2 * k, 1);
          wgmma_tf32(d, f[k][0], f[k][1], f[k][2], f[k][3], dhi + 2 * k, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_operands(d);
        fence_frags(f);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += d[i];
        if (++stage == kStages) stage = 0, phase ^= 1;
      }

      // the unit's partial tile straight from the registers, whole: the
      // reduce pass reads only its gates < G and columns < H. Accumulator
      // layout of m64nNk8: acc[4j + 2h + e] is row h's gate, column 8j +
      // 2q + e.
      float* out = p.partial + (size_t)u * kTileFloats;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = out + me.gate[h] * kBN;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j + 2 * q) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// hprev (T, R, 2H) -> hi, lo (2H, T, R_pad): TF32's big and small halves,
// K-major, zero at r in [R, R_pad). One 32 x 32 tile of (r, c) at step t a
// block, read along c and written along r through shared memory.
__global__ void __launch_bounds__(kPassThreads)
hprev_split_kernel(const float* __restrict__ hprev, float* __restrict__ hi, float* __restrict__ lo, int R, int T,
                   int C, int R_pad) {
  __shared__ float tile[kPassTile][kPassTile + 1];
  const int r0 = blockIdx.x * kPassTile, c0 = blockIdx.y * kPassTile, t = blockIdx.z;
  const int tx = threadIdx.x % kPassTile, ty = threadIdx.x / kPassTile;
  constexpr int kRowsAPass = kPassThreads / kPassTile;
#pragma unroll
  for (int i = ty; i < kPassTile; i += kRowsAPass) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = r < R && c < C ? __ldg(hprev + ((size_t)t * R + r) * C + c) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kPassTile; i += kRowsAPass) {
    const int c = c0 + i, r = r0 + tx;
    if (c < C && r < R_pad) {
      float h, l;
      split(tile[tx][i], h, l);
      const size_t o = ((size_t)c * T + t) * R_pad + r;
      hi[o] = h;
      lo[o] = l;
    }
  }
}

// The partials -> dW_f, dW_b (H, G): element (h, g) of direction dir is
// the sum over splits s, in order, of unit (s, tile of (dir, g, h))'s (g %
// 128, h % 128). One 32 x 32 tile of (g, h) a block, read along h and
// written along g through shared memory.
__global__ void __launch_bounds__(kPassThreads)
whh_grad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out_f, float* __restrict__ out_b,
                       const Params p) {
  __shared__ float tile[kPassTile][kPassTile + 1];
  const int g0 = blockIdx.x * kPassTile, h0 = blockIdx.y * kPassTile, dir = blockIdx.z;
  const int tx = threadIdx.x % kPassTile, ty = threadIdx.x / kPassTile;
  constexpr int kRowsAPass = kPassThreads / kPassTile;
#pragma unroll
  for (int i = ty; i < kPassTile; i += kRowsAPass) {
    const int g = g0 + i, h = h0 + tx;
    float sum = 0.f;
    if (g < p.G && h < p.H) {
      const int tile_idx = (dir * p.m_tiles_dir + g / kBM) * p.n_tiles + h / kBN;
      const float* src = partial + (size_t)tile_idx * kTileFloats + (g % kBM) * kBN + h % kBN;
      for (int s = 0; s < p.splits; ++s) sum += __ldg(src + (size_t)s * p.tiles * kTileFloats);
    }
    tile[i][tx] = sum;
  }
  __syncthreads();
  float* out = dir ? out_b : out_f;
#pragma unroll
  for (int i = ty; i < kPassTile; i += kRowsAPass) {
    const int h = h0 + i, g = g0 + tx;
    if (h < p.H && g < p.G) out[(size_t)h * p.G + g] = tile[tx][i];
  }
}

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of its launches
// (0 = cudaSuccess).
//
// whh_grad_f32_launch. hprev: (T, R, 2H) fp32; dxf, dxb: (T, R, 4H) fp32,
// kernel 4's dgates in kernel time; h_split: scratch of 2 * 2H * T * R_pad
// fp32 (hprev_hi then hprev_lo); partial: scratch of splits * tiles * 128 *
// 128 fp32, tiles = 2 ceil(4H / 128) ceil(H / 128); out_f, out_b: (H, 4H)
// fp32. Runs the split pass, the product and the reduce pass on
// ``stream``. Needs R_pad % 4 == 0 (16-byte strides), R_pad >= R, 1 <=
// splits <= min(1024, T ceil(R / 32)) (every split at least one k-block),
// and 16-byte aligned pointers.
extern "C" int whh_grad_f32_launch(const void* hprev, const void* dxf, const void* dxb, void* h_split,
                                   void* partial, void* out_f, void* out_b, int R, int T, int H, int R_pad,
                                   int splits, void* stream) {
  if (R <= 0 || T <= 0 || H <= 0 || H > (1 << 20) || R_pad < R || R_pad % 4 || T > 65535 ||
      (long long)R * T > 0x7fffffffLL || splits < 1 || splits > kMaxSplits ||
      (long long)splits > (long long)T * ((R + kBK - 1) / kBK))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[7] = {hprev, dxf, dxb, h_split, partial, out_f, out_b};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  const int G = 4 * H, C = 2 * H;
  float* h_hi = static_cast<float*>(h_split);
  float* h_lo = h_hi + (size_t)C * T * R_pad;
  CUtensorMap map_df, map_db, map_hi, map_lo;
  const long long a_row = 4LL * G, b_row = 4LL * R_pad;
  if (!make_map_3d(&map_df, dxf, G, R, T, a_row, a_row * R, kDgSub, kBK, 1) ||
      !make_map_3d(&map_db, dxb, G, R, T, a_row, a_row * R, kDgSub, kBK, 1) ||
      !make_map_3d(&map_hi, h_hi, R_pad, T, C, b_row, b_row * T, kBK, 1, kBN) ||
      !make_map_3d(&map_lo, h_lo, R_pad, T, C, b_row, b_row * T, kBK, 1, kBN))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(whh_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 pass_grid((R_pad + kPassTile - 1) / kPassTile, (C + kPassTile - 1) / kPassTile, T);
  hprev_split_kernel<<<pass_grid, kPassThreads, 0, s>>>(static_cast<const float*>(hprev), h_hi, h_lo, R, T, C,
                                                         R_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.partial = static_cast<float*>(partial);
  p.R = R, p.T = T, p.H = H, p.G = G;
  p.m_tiles_dir = (G + kBM - 1) / kBM;
  p.n_tiles = (H + kBN - 1) / kBN;
  p.tiles = 2 * p.m_tiles_dir * p.n_tiles;
  p.splits = splits;
  p.units = splits * p.tiles;
  p.r_blocks = (R + kBK - 1) / kBK;
  p.k_blocks = T * p.r_blocks;
  const int grid = p.units < sms ? p.units : sms;
  whh_grad_kernel<<<grid, kThreads, kSmemBytes, s>>>(map_df, map_db, map_hi, map_lo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 reduce_grid((G + kPassTile - 1) / kPassTile, (H + kPassTile - 1) / kPassTile, 2);
  whh_grad_reduce_kernel<<<reduce_grid, kPassThreads, 0, s>>>(p.partial, static_cast<float*>(out_f),
                                                               static_cast<float*>(out_b), p);
  return (int)cudaGetLastError();
}

// The product's dynamic shared memory in bytes (ptxas reports only static
// shared memory).
extern "C" int whh_grad_f32_smem_bytes() { return kSmemBytes; }
