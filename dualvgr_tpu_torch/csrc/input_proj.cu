// The BiLSTM input projection in bf16 on the tensor cores (TMA + wgmma), and
// the tanh pass that feeds it.
//
// Replaces the TPU kernels benchmarks/proj_probe.py::make_pallas_proj (one
// direction, optionally written time-reversed) and ::make_pallas_both (both
// directions from one pass over x, the backward one time-reversed, tanh
// applied or x already bf16). Contract, per direction d with weights W_d
// (G, D) and bias b_d (G,), G = 4H:
//
//   out_d[t'] [r, :] = bf16( bf16(f(x[r, t, :])) @ bf16(W_d)^T + b_d )
//
// with f = tanh on fp32 x or the identity on bf16 x, the product accumulated
// in fp32, the fp32 bias added, and one rounding to bf16 at the end; t' = t,
// or T-1-t for a time-reversed direction. x is (R, T, D), out_d (T, R, G),
// time-major: the layout the recurrence kernels read. The wrapper
// (ops/proj_kernel.py) concatenates the directions' weights into one
// (ndir * G, D) bf16 matrix and their biases into one (ndir * G,) fp32
// vector, and for fp32 x runs tanh_to_bf16 first.
//
// tanh_to_bf16: accurate tanhf of fp32 x, rounded to nearest even to bf16,
// 8 elements (two 16-byte loads, one 16-byte store) a thread. It applies
// tanh once per element; the TPU kernels' fused form does it per tile of x,
// which a GEMM tiled over N would repeat once per N tile (24 times at the
// flagship). Bound by bytes: 4 + 2 bytes an element, 805 MB at R = 4096,
// T = 16, D = 2048: 0.24 ms at 3.35 TB/s.
//
// The GEMM. x (R, T, D) contiguous is an (M = R*T, K = D) row-major matrix
// and W (N = ndir * G, K) is K-major, so C = A B^T is the "TN" product that
// wgmma reads as it lies; the time-major layout and the reversal live only
// in the epilogue, which maps row m = r*T + t to output row t' * R + r.
// - A persistent grid: one 384-thread block per SM walks the 128 x 256
//   output tiles, N tiles fastest, so the 132 tiles in flight share about
//   11 row panels of A and all of W (12.6 MB at the flagship) in the 50 MB
//   L2.
// - Warp specialisation. One producer warpgroup (one thread issues) feeds a
//   ring of 3 shared-memory stages with TMA: per stage a 128 x 64 tile of A
//   and a 256 x 64 tile of W (48 KB), 128-byte swizzled, completion counted
//   on a "full" mbarrier in bytes. Ragged M, N and K are zero-filled by TMA.
// - Two consumer warpgroups, each 64 rows x 256 columns of the tile with
//   wgmma.m64n256k16 (bf16 in, fp32 accumulators, 128 registers a thread),
//   A and B both read from shared memory through matrix descriptors. A
//   stage is handed back on an "empty" mbarrier once the wgmma group that
//   read it has retired, so one group stays in flight. setmaxnreg gives the
//   consumers 232 registers and the producer 40.
// - The epilogue: the fp32 bias is added to the accumulators, each pair is
//   rounded once to bf16 and staged in shared memory (a 66 KB tile beside
//   the ring), and one thread a row hands its 512 bytes to a bulk async copy
//   (cp.async.bulk) into the output row of (t', r), split in two where the
//   columns straddle the directions. The copies drain while the consumers
//   run the next tile's products, whose loads the producer has already
//   issued: the consumers stall only for the staging. Stores from the
//   registers instead, 16 bytes a lane, left the tensor cores idle for a
//   quarter of the time (bench/proj_kernel_ab.py, PERF.md).
//
// Bound on the H100: 2 * R*T * D * N operations on the tensor cores, 825
// GFLOP for both directions at the flagship: 0.83 ms at 989 TFLOP/s, against
// 0.20 ms for its 684 MB of HBM traffic (x in bf16, W, out), so it is bound
// by operations.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the tile and the ring; bench/proj_kernel_ab.py times other choices
constexpr int kBM = 128, kBN = 256, kBK = 64;  // kBK bf16 = 128 bytes: one swizzle row
constexpr int kStages = 3;
static_assert(kBN == 128 || kBN == 256, "wgmma n128 or n256");
constexpr int kAcc = kBN / 2;                 // fp32 accumulators a consumer thread
constexpr int kConsumers = 2;                 // warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
// the output tile staged in bf16 for the bulk stores; 16 bytes of padding
// a row put the 8 rows a warp writes at once on distinct banks
constexpr int kOutLd = kBN * 2 + 16;
constexpr int kOutBytes = kBM * kOutLd;
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment
constexpr int kTanhThreads = 256;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase parity differs from ``parity``. A wait
// of more than 2^34 cycles (about 10 s) can only be a fault in the
// pipeline: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// ``bytes`` (a multiple of 16) from shared to global memory, asynchronously,
// in this thread's current bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// a (kBK x rows) box of a 2-D bf16 tensor map at (k, row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile with 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO); the leading offset is unused in this mode
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, fp32) += A (64 x 16) B^T (256 x 16), both from shared memory
__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"  // scale-d: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16) B^T (128 x 16), both from shared memory
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"  // scale-d: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

struct Epilogue {
  const float* bias;
  __nv_bfloat16* out[2];
  int reverse[2];
  int R, T, G, M, N;
};

__global__ void __launch_bounds__(kThreads, 1)
input_proj_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                  const Epilogue ep, int k_blocks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;                        // kStages x (kBM x kBK)
  uint8_t* sb = smem + kStages * kABytes;    // kStages x (kBN x kBK)
  uint8_t* so = smem + kStages * kStageBytes;  // kBM rows of kOutLd bytes
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

  const int n_tiles = (ep.N + kBN - 1) / kBN;
  const int tiles = ((ep.M + kBM - 1) / kBM) * n_tiles;

  if (wg == kConsumers) {
    // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
        for (int kb = 0; kb < k_blocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_expect_tx(&full[stage], kStageBytes);
          tma_load(sa + stage * kABytes, &map_a, &full[stage], kb * kBK, m0);
          tma_load(sb + stage * kBBytes, &map_b, &full[stage], kb * kBK, n0);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int tid = threadIdx.x % 128, lane = tid % 32, warp = tid / 32, q = lane % 4;
    uint8_t* rows = so + wg * 64 * kOutLd;  // this warpgroup's 64 staged rows
    int stage = 0;
    uint32_t phase = 0;
    float d[kAcc];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < k_blocks; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint64_t da = smem_desc(sa + stage * kABytes + wg * 64 * kBK * 2);
        const uint64_t db = smem_desc(sb + stage * kBBytes);
        fence_operands(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 16 bf16 = 32 bytes = 2 descriptor units
          wgmma(d, da + 2 * kk, db + 2 * kk);
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
        fence_operands(d);
        if (prev >= 0) {  // the previous group has retired: its stage is free
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == kStages) stage = 0, phase ^= 1;
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);

      // epilogue. The bulk stores of the previous tile have long read
      // these rows (the threads that issued them wait for it), so they are
      // free. Accumulator layout of m64nNk16: d[4j + 2h + e] is row
      // 16 * warp + lane / 4 + 8h, column 8j + 2q + e of the warpgroup's tile.
      if (tid < 64) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_barrier(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * q;
        const float2 b = n < ep.N ? __ldg(reinterpret_cast<const float2*>(ep.bias + n)) : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(rows + (warp * 16 + lane / 4 + 8 * h) * kOutLd + (8 * j + 2 * q) * 2) =
              pack_bf16(d[4 * j + 2 * h] + b.x, d[4 * j + 2 * h + 1] + b.y);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the bulk copies
      named_barrier(1 + wg, 128);
      // one thread a staged row: its columns [n0, n_end) go to the output
      // row of (t', r) in one direction, or in two where they straddle G
      const int m = m0 + wg * 64 + tid;
      if (tid < 64 && m < ep.M) {
        const int r = m / ep.T, t = m % ep.T, n_end = min(n0 + kBN, ep.N);
        for (int n = n0; n < n_end;) {
          const int dir = n >= ep.G, seg_end = dir ? n_end : min(n_end, ep.G);
          const int tt = (dir ? ep.reverse[1] : ep.reverse[0]) ? ep.T - 1 - t : t;
          __nv_bfloat16* dst = (dir ? ep.out[1] : ep.out[0]) + ((size_t)tt * ep.R + r) * ep.G + (n - dir * ep.G);
          bulk_store(dst, rows + tid * kOutLd + (n - n0) * 2, (seg_end - n) * 2);
          n = seg_end;
        }
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
    // the last tile's stores complete before the block's shared memory goes
    if (tid < 64) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

__global__ void __launch_bounds__(kTanhThreads)
tanh_to_bf16_kernel(const float4* __restrict__ x, uint4* __restrict__ out, long long n8) {
  for (long long i = (long long)blockIdx.x * kTanhThreads + threadIdx.x; i < n8;
       i += (long long)gridDim.x * kTanhThreads) {
    const float4 a = __ldg(x + 2 * i), b = __ldg(x + 2 * i + 1);
    // accurate tanhf: an approximate tanh would flip bf16 roundings
    out[i] = make_uint4(pack_bf16(tanhf(a.x), tanhf(a.y)), pack_bf16(tanhf(a.z), tanhf(a.w)),
                        pack_bf16(tanhf(b.x), tanhf(b.y)), pack_bf16(tanhf(b.z), tanhf(b.w)));
  }
}

// cuTensorMapEncodeTiled, taken from the driver at run time, so that the
// library needs no link to libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix read in (box_rows x kBK) boxes, 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Plain C entries for ctypes. Each returns the cudaError_t of the launch
// (0 = cudaSuccess).
//
// input_proj_launch. x: (R, T, D) bf16; w: (ndir * G, D) bf16; bias:
// (ndir * G,) fp32; out_f, out_b: (T, R, G) bf16 (out_b only for ndir == 2);
// reverse_*: 1 writes that direction time-reversed. Needs D % 8 == 0 and
// G % 8 == 0 (16-byte rows and column groups) and 16-byte aligned pointers.
extern "C" int input_proj_launch(const void* x, const void* w, const void* bias, void* out_f, void* out_b,
                                 int reverse_f, int reverse_b, int R, int T, int D, int G, int ndir,
                                 void* stream) {
  if (R <= 0 || T <= 0 || D <= 0 || G <= 0 || D % 8 || G % 8 || (ndir != 1 && ndir != 2) ||
      (ndir == 2 && out_b == nullptr) || (long long)R * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(w) || !aligned16(bias) || !aligned16(out_f) || (ndir == 2 && !aligned16(out_b)))
    return (int)cudaErrorMisalignedAddress;
  const int M = R * T, N = ndir * G;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, x, M, D, kBM) || !make_map(&map_b, w, N, D, kBN)) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(input_proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  Epilogue ep;
  ep.bias = static_cast<const float*>(bias);
  ep.out[0] = static_cast<__nv_bfloat16*>(out_f);
  ep.out[1] = static_cast<__nv_bfloat16*>(ndir == 2 ? out_b : out_f);
  ep.reverse[0] = reverse_f;
  ep.reverse[1] = reverse_b;
  ep.R = R, ep.T = T, ep.G = G, ep.M = M, ep.N = N;
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  input_proj_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, ep, (D + kBK - 1) / kBK);
  return (int)cudaGetLastError();
}

// The projection kernel's dynamic shared memory in bytes (ptxas reports only
// static shared memory).
extern "C" int input_proj_smem_bytes() { return kSmemBytes; }

// tanh_to_bf16_launch. x: n fp32, out: n bf16, n % 8 == 0, 16-byte aligned.
extern "C" int tanh_to_bf16_launch(const void* x, void* out, long long n, void* stream) {
  if (n <= 0 || n % 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(out)) return (int)cudaErrorMisalignedAddress;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const long long n8 = n / 8, blocks = (n8 + kTanhThreads - 1) / kTanhThreads;
  const int grid = (int)(blocks < 16LL * sms ? blocks : 16LL * sms);
  tanh_to_bf16_kernel<<<grid, kTanhThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<uint4*>(out), n8);
  return (int)cudaGetLastError();
}
