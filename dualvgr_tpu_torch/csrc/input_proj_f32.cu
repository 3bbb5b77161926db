// Kernel 7: the BiLSTM input projection in fp32 on the tensor cores, as
// 3xTF32, both directions from one pass over x.
//
// Replaces no TPU kernel. The JAX package leaves the fp32 projection to
// XLA (dualvgr_tpu/ops/lstm.py::time_major_input_proj, one einsum a
// direction), and the port left it to two torch.baddbmm calls, which run on
// the FFMA pipes near their 67 TFLOP/s, plus a bias broadcast and a copy
// that flips the backward direction in time. At the appearance encoder's
// shapes that product is the largest operation of the train steps. The
// H100's tensor cores take TF32 at 495 TFLOP/s; 3xTF32 keeps fp32's
// precision on them. Contract, per direction d with weights W_d (G, D) and
// combined bias b_d (G,), G = 4H:
//
//   out_f[t]     [r, :] = x[r, t, :] @ W_f^T + b_f
//   out_b[T-1-t] [r, :] = x[r, t, :] @ W_b^T + b_b
//
// all fp32; x (R, T, D), out_d (T, R, G): the layout kernels 1 and 3 read.
//
// 3xTF32. Each operand a is split into big = tf32(a) and small = tf32(a -
// big), rounded to nearest, 11 + 11 significant bits that together carry a
// to about 2^-22 of itself; the kernel sums small x big + big x small + big
// x big and drops small x small, about 2^-22 of a product. The tensor cores
// add each k8 slice into their fp32 accumulator rounding toward zero, not
// to nearest: summed there over all 2,048 terms, the product's error
// against fp64 read 17.7x baddbmm's fp32 error on the card. So each
// k-block's 32 terms are summed in the tensor cores from zero and then
// added into a second accumulator with fp32 adds on the CUDA cores
// ("promotion"): 0.35x baddbmm's error at the flagship (PERF.md).
// tests/test_torch_kernels_cuda.py holds it at the cells' shapes to twice
// baddbmm's error against fp64, and plain TF32 outside that bound.
//
// The GEMM. x (R, T, D) contiguous is an (M = R*T, K = D) row-major matrix
// and W = [W_f; W_b] (N = 2G, K) is K-major: C = A B^T is the "TN" product
// that wgmma reads as it lies (.tf32 takes K-major operands only); the
// time-major layout and the reversal live only in the epilogue, which maps
// row m = r*T + t to output row t' * R + r. Kernel 6's skeleton
// (tma_gemm.cuh):
// - A persistent grid: one 384-thread block per SM walks the 128 x 128
//   output tiles in groups of kGroupN N tiles, N fastest within a group, so
//   the 132 tiles in flight share about 17 row panels of x (17 MB) and a
//   group's W_hi and W_lo (17 MB) in the 50 MB L2; x comes from HBM about
//   N / (128 kGroupN) = 3 times.
// - A small pass first splits W into W_hi and W_lo (fp32 values with TF32's
//   bits, 2 x 2G x D, the wrapper's scratch): 25 MB read and 50 MB written
//   at the flagship, about 25 us.
// - Warp specialisation. One producer thread feeds a ring of 3 stages with
//   TMA: per stage a 128 x 32 tile of x and 128 x 32 tiles of W_hi and W_lo
//   (48 KB, 128-byte swizzled). Ragged M, N and K are zero-filled by TMA.
// - Two consumer warpgroups, each 64 rows x 128 columns of the tile. A
//   comes from registers: each thread reads its 16 values of the stage's x
//   tile (4-byte loads, no bank conflicts under the swizzle) and splits
//   them itself, so x crosses HBM and shared memory once. B (W_hi, W_lo)
//   comes from shared memory through matrix descriptors. A k-block is 12
//   wgmma.m64n128k8.f32.tf32.tf32, three a k8 slice: small_x big_W, big_x
//   small_W, big_x big_W, the small terms first. Each warpgroup then waits
//   for its group, hands the stage back and promotes; the two warpgroups'
//   groups interleave on the tensor cores, so one's wait hides behind the
//   other's products. Promoting every second or fourth k-block instead,
//   with the next k-block's fragments loaded while a group is in flight,
//   keeps more registers live than the 168 a thread of a 384-thread block
//   gets (setmaxnreg does not raise what ptxas allocates): they spilled,
//   and took 9.8 and 8.1 ms at the flagship against 6.7 (PERF.md); with
//   the waits on divergent paths ptxas serialized the wgmmas (C7518).
//   setmaxnreg gives the consumers 232 registers and the producer 40, as
//   in kernel 6.
// - The epilogue: the fp32 bias is added, each warpgroup stages its 64 rows
//   in shared memory (a 68 KB tile beside the 144 KB ring), and one thread
//   a row hands its 512 bytes to a bulk async copy into the output row of
//   (t', r), split in two where the columns straddle the directions; the
//   copies drain while the next tile's products run.
//
// Bound on the H100: 2 * R*T * D * 2G operations a product, three products
// on the tensor cores. At the flagship train step (R*T = 65,536, D = 2,048,
// 2G = 3,072) that is 3 x 824 GFLOP, 5.0 ms at 495 TFLOP/s, against about
// 0.5 ms for its bytes (x once, W_hi and W_lo, the 805 MB output): bound by
// operations. An FFMA product of the same 824 GFLOP needs 12.3 ms at 67
// TFLOP/s.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_gemm.cuh"

namespace {

using namespace tma_gemm;

// the tile, the ring and the raster; bench/proj_kernel_ab.py
// times other choices
constexpr int kBM = 128, kBN = 128, kBK = 32;  // kBK fp32 = 128 bytes: one swizzle row
constexpr int kStages = 3;
constexpr int kGroupN = 8;  // N tiles in one group of the raster
static_assert(kBN == 128, "wgmma n128");
constexpr int kAcc = kBN / 2;  // fp32 accumulators a consumer thread
constexpr int kSteps = kBK / 8;  // k8 slices a k-block
constexpr int kConsumers = 2;    // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 4, kBBytes = kBN * kBK * 4;
constexpr int kStageBytes = kABytes + 2 * kBBytes;  // x, W_hi, W_lo
// the output tile staged in fp32 for the bulk stores; 32 bytes of padding a
// row put the 16 lanes of a float2 store on distinct banks
constexpr int kOutLd = kBN * 4 + 32;
constexpr int kOutBytes = kBM * kOutLd;
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can have");
constexpr int kSplitThreads = 256;

struct Epilogue {
  const float* bias_f;
  const float* bias_b;
  float* out_f;
  float* out_b;
  int R, T, G, M, N, k_blocks;
};

// The origin (m0, n0) of output tile ``tile``: groups of kGroupN N tiles,
// N fastest within a group.
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles, int& m0, int& n0) {
  const int per_group = kGroupN * m_tiles;
  const int group = tile / per_group, idx = tile % per_group;
  const int first = group * kGroupN, width = min(kGroupN, n_tiles - first);
  m0 = (idx / width) * kBM;
  n0 = (first + idx % width) * kBN;
}

// The thread's fragments of the x tile's k-block in ``a``, split: f[s][0..3]
// the big halves of slice s, f[s][4..7] the small ones, in the A layout of
// wgmma m64nNk8 .tf32 (register i: row + 8 (i & 1), column 8 s + t + 4 (i >> 1),
// row = its first row of the tile, t = lane % 4). Under the 128-byte
// swizzle the 16-byte chunk c of row r lies at c ^ (r % 8), and r % 8 =
// lane / 4 = g for both rows.
__device__ __forceinline__ void load_split(uint32_t (&f)[kSteps][8], const uint8_t* a, int row, int g, int t) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c0 = (((2 * s) ^ g) << 4) + 4 * t, c1 = (((2 * s + 1) ^ g) << 4) + 4 * t;
    const float v[4] = {*reinterpret_cast<const float*>(a + row * 128 + c0),
                        *reinterpret_cast<const float*>(a + (row + 8) * 128 + c0),
                        *reinterpret_cast<const float*>(a + row * 128 + c1),
                        *reinterpret_cast<const float*>(a + (row + 8) * 128 + c1)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[s][i] = tf32(v[i]);
      f[s][4 + i] = tf32(v[i] - __uint_as_float(f[s][i]));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
input_proj_f32_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_hi,
                      const __grid_constant__ CUtensorMap map_lo, const Epilogue ep) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                            // kStages x (kBM x kBK)
  uint8_t* sb = smem + kStages * kABytes;        // kStages x (W_hi, W_lo), kBN x kBK each
  uint8_t* so = smem + kStages * kStageBytes;    // kBM rows of kOutLd bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(so + kOutBytes);
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

  const int m_tiles = (ep.M + kBM - 1) / kBM, n_tiles = (ep.N + kBN - 1) / kBN;
  const int tiles = m_tiles * n_tiles;

  if (wg == kConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m_tiles, n_tiles, m0, n0);
        for (int kb = 0; kb < ep.k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          uint8_t* b = sb + stage * 2 * kBBytes;
          tma_load(sa + stage * kABytes, &map_x, &full[stage], kb * kBK, m0);
          tma_load(b, &map_hi, &full[stage], kb * kBK, n0);
          tma_load(b + kBBytes, &map_lo, &full[stage], kb * kBK, n0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32, q = lane % 4;
    uint8_t* rows = so + wg * 64 * kOutLd;  // this warpgroup's 64 staged rows
    const int row = wg * 64 + warp * 16 + lane / 4;  // the thread's first row of the x tile; + 8 the second
    int stage = 0;
    uint32_t phase = 0;
    float d[kAcc], acc[kAcc];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, m0, n0);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < ep.k_blocks; ++kb) {
        // the k-block: the thread's x fragments split, 3 kSteps wgmmas
        // into d (the first overwriting it), retired, the stage handed
        // back, and d promoted into acc with fp32 adds
        uint32_t f[kSteps][8];
        mbar_wait(&full[stage], phase);
        load_split(f, sa + stage * kABytes, row, lane / 4, q);
        const uint64_t dhi = smem_desc(sb + stage * 2 * kBBytes), dlo = smem_desc(sb + stage * 2 * kBBytes + kBBytes);
        fence_frags(f);
        fence_operands(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {  // 8 tf32 = 32 bytes = 2 descriptor units
          wgmma_tf32(d, f[s][4], f[s][5], f[s][6], f[s][7], dhi + 2 * s, s == 0 ? 0 : 1);
          wgmma_tf32(d, f[s][0], f[s][1], f[s][2], f[s][3], dlo + 2 * s, 1);
          wgmma_tf32(d, f[s][0], f[s][1], f[s][2], f[s][3], dhi + 2 * s, 1);
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

      // epilogue. The bulk stores of the previous tile have long read
      // these rows (the threads that issued them wait for it), so they are
      // free. Accumulator layout of m64nNk8: acc[4j + 2h + e] is row
      // 16 * warp + lane / 4 + 8h, column 8j + 2q + e of the warpgroup's tile.
      if (tid < 64) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        const float* bias = n < ep.G ? ep.bias_f + n : ep.bias_b + (n - ep.G);
        const float2 b = n < ep.N ? __ldg(reinterpret_cast<const float2*>(bias)) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(rows + (warp * 16 + lane / 4 + 8 * h) * kOutLd + (8 * j + 2 * q) * 4) =
              make_float2(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the bulk copies
      named_barrier(1 + wg, 128);
      // one thread a staged row: its columns [n0, n_end) go to the output
      // row of (t', r) in one direction, or in two where they straddle G;
      // the backward direction is written time-reversed
      const int m = m0 + wg * 64 + tid;
      if (tid < 64 && m < ep.M) {
        const int r = m / ep.T, t = m % ep.T, n_end = min(n0 + kBN, ep.N);
        for (int n = n0; n < n_end;) {
          const int dir = n >= ep.G, seg_end = dir ? n_end : min(n_end, ep.G);
          const int tt = dir ? ep.T - 1 - t : t;
          float* dst = (dir ? ep.out_b : ep.out_f) + ((size_t)tt * ep.R + r) * ep.G + (n - dir * ep.G);
          bulk_store(dst, rows + tid * kOutLd + (n - n0) * 4, (seg_end - n) * 4);
          n = seg_end;
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    // the last tile's stores complete before the block's shared memory goes
    if (tid < 64) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// [W_f; W_b] (2 n4 float4s) -> W_hi, W_lo: TF32's big and small halves
__global__ void __launch_bounds__(kSplitThreads)
tf32_split_kernel(const float4* __restrict__ w_f, const float4* __restrict__ w_b, float4* __restrict__ hi,
                  float4* __restrict__ lo, long long n4) {
  for (long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x; i < 2 * n4;
       i += (long long)gridDim.x * kSplitThreads) {
    const float4 v = __ldg(i < n4 ? w_f + i : w_b + (i - n4));
    float4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of its launches
// (0 = cudaSuccess).
//
// input_proj_f32_launch. x: (R, T, D) fp32; w_f, w_b: (G, D) fp32; b_f, b_b:
// (G,) fp32; w_split: scratch of 2 * 2G * D fp32 (W_hi then W_lo); out_f,
// out_b: (T, R, G) fp32, out_b time-reversed. Runs the split pass, then the
// product, on ``stream``. Needs D % 4 == 0 and G % 4 == 0 (16-byte rows and
// column groups) and 16-byte aligned pointers.
extern "C" int input_proj_f32_launch(const void* x, const void* w_f, const void* w_b, const void* b_f,
                                     const void* b_b, void* w_split, void* out_f, void* out_b, int R, int T, int D,
                                     int G, void* stream) {
  if (R <= 0 || T <= 0 || D <= 0 || G <= 0 || D % 4 || G % 4 || (long long)R * T > 0x7fffffffLL ||
      2LL * G * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[8] = {x, w_f, w_b, b_f, b_b, w_split, out_f, out_b};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  const int M = R * T, N = 2 * G;
  float* w_hi = static_cast<float*>(w_split);
  float* w_lo = w_hi + (size_t)N * D;
  CUtensorMap map_x, map_hi, map_lo;
  if (!make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, D, kBK, kBM) ||
      !make_map(&map_hi, w_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, D, kBK, kBN) ||
      !make_map(&map_lo, w_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, N, D, kBK, kBN))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(input_proj_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n4 = (long long)G * D / 4, blocks = (2 * n4 + kSplitThreads - 1) / kSplitThreads;
  tf32_split_kernel<<<(int)(blocks < 8LL * sms ? blocks : 8LL * sms), kSplitThreads, 0, s>>>(
      static_cast<const float4*>(w_f), static_cast<const float4*>(w_b), reinterpret_cast<float4*>(w_hi),
      reinterpret_cast<float4*>(w_lo), n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Epilogue ep;
  ep.bias_f = static_cast<const float*>(b_f);
  ep.bias_b = static_cast<const float*>(b_b);
  ep.out_f = static_cast<float*>(out_f);
  ep.out_b = static_cast<float*>(out_b);
  ep.R = R, ep.T = T, ep.G = G, ep.M = M, ep.N = N, ep.k_blocks = (D + kBK - 1) / kBK;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  input_proj_f32_kernel<<<grid, kThreads, kSmemBytes, s>>>(map_x, map_hi, map_lo, ep);
  return (int)cudaGetLastError();
}

// The product's dynamic shared memory in bytes (ptxas reports only static
// shared memory).
extern "C" int input_proj_f32_smem_bytes() { return kSmemBytes; }
