// Kernel 8: the appearance BiLSTM's input weight gradient dW_ih in fp32 on
// the tensor cores, as 3xTF32, both directions in one launch.
//
// Replaces no TPU kernel. The JAX package leaves dW_ih to XLA (the
// appearance op's backward, dualvgr_tpu/ops/lstm_pallas_train.py:440-441,
// one einsum a direction), and the port left it to two fp32 library products,
// cuBLAS's SIMT SGEMM on the FFMA pipes, each after a copy that transposed
// one direction's dgates (the backward's flipped back in time): the largest
// operation of every train step. Contract, with kernel 4's dgates dxf, dxb
// (T, R, G) in kernel time (dxb's step t is the sequence's step T-1-t), x
// (R, T, D) and G = 4H:
//
//   dW_f[g, d] = sum over (t, r) of dxf[t, r, g] * x[r, t, d]
//   dW_b[g, d] = sum over (t, r) of dxb[t, r, g] * x[r, T-1-t, d]
//
// all fp32, each dW (G, D) row-major: the (4H, D) layout of w_ih.
//
// The GEMM: M = 2G (both directions' gates), N = D, K = R*T, the same work
// as kernel 7's forward product (input_proj_f32.cu), whose 3xTF32 and
// promotion it keeps (tma_gemm.cuh): each k-block's 12 wgmmas (three a k8
// slice, the small terms first) sum in the tensor cores from zero, and the
// k-block is added into an fp32 register sum on the CUDA cores. Both
// operands lie MN-major over K, and wgmma takes .tf32 operands K-major only:
// - B = x goes through a pass in the same entry that splits it into its
//   TF32 halves and writes them K-major, (D, T, R_pad) each, into the
//   wrapper's scratch; R_pad (R rounded up to 4, from the wrapper) keeps
//   TMA's strides at 16 bytes, and the pass zero-fills the padding. The
//   consumers read B_hi and B_lo through matrix descriptors, as kernel 7
//   reads W_hi and W_lo. The pass reads x once and writes both halves:
//   1.6 GB at the msrvtt-qa step, about 0.5 ms at 3.35 TB/s.
// - A = the dgates comes from registers, read in place from kernel 4's
//   output: the producer's TMA brings the MN-major tile, 32 k rows by 128
//   gates, as four boxes of 32 gates (128 bytes a k row, 128-byte
//   swizzled), and each consumer thread reads its fragment column-wise out
//   of it, which transposes it, and splits it itself. Which gate a
//   fragment row holds is free (the accumulator's row is the same gate), so
//   the rows are permuted (DgatesReader::gate, tma_gemm.cuh) until a
//   warp's 32 transposed reads fall on 32 distinct banks under the swizzle.
// - The K walk never straddles a time step: a k-block is 32 rows r of one
//   step t, and a tile of dW_b reads B at step T-1-t, so the time reversal
//   lives in the coordinates and in no copy. TMA zero-fills a ragged R per
//   step: the dgates are a 3-D map (G, R, T), the x halves (R_pad, T, D).
// - A persistent grid: one 384-thread block per SM walks the 128 x 128
//   output tiles, N fastest (384 tiles at the flagship, 2.9 waves; K is
//   long enough that no split is needed). The blocks walk K in step, so at
//   any time the tiles in flight read the same k-block of about 8 row
//   panels of the dgates and of every column panel of the x halves (under
//   1 MB a k-block), and each is read from HBM about once a wave.
// - Warp specialisation as in kernel 7: one producer thread feeds a ring of
//   4 stages (the dgates, B_hi and B_lo tiles, 48 KB a stage); two consumer
//   warpgroups of 64 gates x 128 columns each; setmaxnreg gives the
//   consumers 232 registers and the producer 40. The fp32 tile is stored
//   from the registers once at its end, 64 KB a tile: no staging.
//
// Bound on the H100: 2 * R*T * D * 2G operations a product, three products
// on the tensor cores. At the msrvtt-qa train step (R*T = 65,536, D =
// 2,048, 2G = 3,072) that is 3 x 824 GFLOP, 5.0 ms at 495 TFLOP/s, against
// about 0.4 ms for its bytes (the dgates and x once, dW): bound by
// operations. The SGEMM it replaces needs 12.3 ms at the FFMA pipes' 67
// TFLOP/s.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_gemm.cuh"

namespace {

using namespace tma_gemm;

constexpr int kBM = 128, kBN = 128, kBK = 32;  // kBK fp32 = 128 bytes: one swizzle row
constexpr int kStages = 4;
static_assert(kBN == 128, "wgmma n128");
constexpr int kAcc = kBN / 2;    // fp32 accumulators a consumer thread
constexpr int kSteps = kBK / 8;  // k8 slices a k-block
constexpr int kConsumers = 2;    // warpgroups, 64 gates each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSub = 32;                           // gates a box of the dgates: 128 bytes
constexpr int kSubBytes = kBK * kSub * 4;          // 4 KB, 1024-byte aligned in the stage
constexpr int kABytes = kBM * kBK * 4, kBBytes = kBN * kBK * 4;
constexpr int kStageBytes = kABytes + 2 * kBBytes;  // the dgates, B_hi, B_lo
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can have");
constexpr int kPassTile = 32, kPassThreads = 256;

struct Params {
  float* out_f;
  float* out_b;
  int R, T, D, G;
  int m_tiles_dir, n_tiles, tiles, k_blocks;
};

// The tile's direction, first gate within the direction and first column:
// 128-gate tiles within one direction, N fastest.
__device__ __forceinline__ void tile_origin(int tile, const Params& p, int& dir, int& m0, int& n0) {
  const int mi = tile / p.n_tiles;
  dir = mi >= p.m_tiles_dir;
  m0 = (mi - dir * p.m_tiles_dir) * kBM;
  n0 = (tile % p.n_tiles) * kBN;
}

static_assert(kBK == kDgK && kSub == kDgSub, "the dgates tile that tma_gemm.cuh's DgatesReader reads");

__global__ void __launch_bounds__(kThreads, 1)
wgrad_f32_kernel(const __grid_constant__ CUtensorMap map_df, const __grid_constant__ CUtensorMap map_db,
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
    // producer: k-block (t, r0) of tile (dir, m0, n0) is the dgates' box at
    // (m0 + 32 j, r0, t) and the x halves' at (r0, t or T-1-t, n0)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        int dir, m0, n0;
        tile_origin(tile, p, dir, m0, n0);
        const CUtensorMap* map_a = dir ? &map_db : &map_df;
        for (int t = 0; t < p.T; ++t) {
          const int tx = dir ? p.T - 1 - t : t;
          for (int r0 = 0; r0 < p.R; r0 += kBK) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], kStageBytes);
            uint8_t* s = smem + stage * kStageBytes;
#pragma unroll
            for (int j = 0; j < kBM / kSub; ++j) tma_load_3d(s + j * kSubBytes, map_a, &full[stage], m0 + j * kSub, r0, t);
            tma_load_3d(s + kABytes, &map_hi, &full[stage], r0, tx, n0);
            tma_load_3d(s + kABytes + kBBytes, &map_lo, &full[stage], r0, tx, n0);
            if (++stage == kStages) stage = 0, phase ^= 1;
          }
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
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      int dir, m0, n0;
      tile_origin(tile, p, dir, m0, n0);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < p.k_blocks; ++kb) {
        // the k-block: the thread's dgates fragments split, 3 kSteps
        // wgmmas into d (the first overwriting it), retired, the stage
        // handed back, and d promoted into acc with fp32 adds
        uint32_t f[kSteps][8];
        const uint8_t* s = smem + stage * kStageBytes;
        mbar_wait(&full[stage], phase);
        me.load_split(f, s);
        const uint64_t dhi = smem_desc(s + kABytes), dlo = smem_desc(s + kABytes + kBBytes);
        fence_frags(f);
        fence_operands(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {  // 8 tf32 = 32 bytes = 2 descriptor units
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

      // the tile's rows straight from the registers. Accumulator layout of
      // m64nNk8: acc[4j + 2h + e] is row h's gate, column 8j + 2q + e.
      float* out = dir ? p.out_b : p.out_f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + me.gate[h];
        if (m < p.G) {
          float* row = out + (size_t)m * p.D;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int n = n0 + 8 * j + 2 * q;
            if (n < p.D) *reinterpret_cast<float2*>(row + n) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// x (R, T, D) -> hi, lo (D, T, R_pad): TF32's big and small halves, K-major,
// zero at r in [R, R_pad). One 32 x 32 tile of (r, d) at step t a block,
// read along d and written along r through shared memory.
__global__ void __launch_bounds__(kPassThreads)
x_split_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo, int R, int T, int D,
               int R_pad) {
  __shared__ float tile[kPassTile][kPassTile + 1];
  const int r0 = blockIdx.x * kPassTile, d0 = blockIdx.y * kPassTile, t = blockIdx.z;
  const int tx = threadIdx.x % kPassTile, ty = threadIdx.x / kPassTile;
  constexpr int kRowsAPass = kPassThreads / kPassTile;
#pragma unroll
  for (int i = ty; i < kPassTile; i += kRowsAPass) {
    const int r = r0 + i, dd = d0 + tx;
    tile[i][tx] = r < R && dd < D ? __ldg(x + ((size_t)r * T + t) * D + dd) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kPassTile; i += kRowsAPass) {
    const int dd = d0 + i, r = r0 + tx;
    if (dd < D && r < R_pad) {
      float h, l;
      split(tile[tx][i], h, l);
      const size_t o = ((size_t)dd * T + t) * R_pad + r;
      hi[o] = h;
      lo[o] = l;
    }
  }
}

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of its launches
// (0 = cudaSuccess).
//
// wgrad_f32_launch. x: (R, T, D) fp32; dxf, dxb: (T, R, G) fp32, kernel 4's
// dgates in kernel time; x_split: scratch of 2 * D * T * R_pad fp32 (x_hi
// then x_lo); out_f, out_b: (G, D) fp32. Runs the split pass, then the
// product, on ``stream``. Needs D % 4 == 0, G % 4 == 0 and R_pad % 4 == 0
// (16-byte strides), R_pad >= R, and 16-byte aligned pointers.
extern "C" int wgrad_f32_launch(const void* x, const void* dxf, const void* dxb, void* x_split, void* out_f,
                                void* out_b, int R, int T, int D, int G, int R_pad, void* stream) {
  if (R <= 0 || T <= 0 || D <= 0 || G <= 0 || D % 4 || G % 4 || R_pad < R || R_pad % 4 || T > 65535 ||
      (long long)R * T > 0x7fffffffLL || (D + kPassTile - 1) / kPassTile > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {x, dxf, dxb, x_split, out_f, out_b};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  float* x_hi = static_cast<float*>(x_split);
  float* x_lo = x_hi + (size_t)D * T * R_pad;
  CUtensorMap map_df, map_db, map_hi, map_lo;
  const long long a_row = 4LL * G, b_row = 4LL * R_pad;
  if (!make_map_3d(&map_df, dxf, G, R, T, a_row, a_row * R, kSub, kBK, 1) ||
      !make_map_3d(&map_db, dxb, G, R, T, a_row, a_row * R, kSub, kBK, 1) ||
      !make_map_3d(&map_hi, x_hi, R_pad, T, D, b_row, b_row * T, kBK, 1, kBN) ||
      !make_map_3d(&map_lo, x_lo, R_pad, T, D, b_row, b_row * T, kBK, 1, kBN))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 pass_grid((R_pad + kPassTile - 1) / kPassTile, (D + kPassTile - 1) / kPassTile, T);
  x_split_kernel<<<pass_grid, kPassThreads, 0, s>>>(static_cast<const float*>(x), x_hi, x_lo, R, T, D, R_pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.out_f = static_cast<float*>(out_f);
  p.out_b = static_cast<float*>(out_b);
  p.R = R, p.T = T, p.D = D, p.G = G;
  p.m_tiles_dir = (G + kBM - 1) / kBM;
  p.n_tiles = (D + kBN - 1) / kBN;
  p.tiles = 2 * p.m_tiles_dir * p.n_tiles;
  p.k_blocks = T * ((R + kBK - 1) / kBK);
  const int grid = p.tiles < sms ? p.tiles : sms;
  wgrad_f32_kernel<<<grid, kThreads, kSmemBytes, s>>>(map_df, map_db, map_hi, map_lo, p);
  return (int)cudaGetLastError();
}

// The product's dynamic shared memory in bytes (ptxas reports only static
// shared memory).
extern "C" int wgrad_f32_smem_bytes() { return kSmemBytes; }
