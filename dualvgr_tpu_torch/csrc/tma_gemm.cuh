// What the tensor-core GEMMs of the BiLSTM share: kernel 6 (input_proj.cu,
// bf16), kernel 7 (input_proj_f32.cu, 3xTF32), kernel 8 (wgrad_f32.cu,
// 3xTF32, the projection's weight gradient) and kernel 9 (whh_grad_f32.cu,
// 3xTF32, the recurrent weight gradient). All are persistent and
// warp-specialised: one producer thread keeps a ring of shared-memory
// stages filled by TMA, each stage's arrival counted in bytes on a "full"
// mbarrier, and consumer warpgroups hand a stage back on an "empty"
// mbarrier once the wgmma that read it has retired. The operands that
// wgmma reads from shared memory lie K-major with the 128-byte swizzle, 128
// bytes of K a tile row. Here: the barriers, the copies, the wgmma matrix
// descriptor, the tensor maps (2-D, and 3-D for kernels 8 and 9's per-step
// boxes), the 3xTF32 arithmetic of kernels 7-9, and kernels 8 and 9's
// reader of the dgates.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tma_gemm {

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

// one box of a 2-D tensor map at (k, row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

// one box of a 3-D tensor map at (c0, c1, c2), the innermost coordinate first
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile with 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO); the leading offset is unused in this mode.
// One unit of the address is 16 bytes: +2 steps 32 bytes along K.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across this point
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 3xTF32 (kernels 7-9). Each operand a is split into big = tf32(a) and
// small = tf32(a - big), rounded to nearest, 11 + 11 significant bits that
// together carry a to about 2^-22 of itself; a product sums small x big +
// big x small + big x big and drops small x small.

// fp32 v rounded to TF32 (nearest, ties away): its 19 high bits, the rest zero
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, float& hi, float& lo) {
  hi = __uint_as_float(tf32(v));
  lo = __uint_as_float(tf32(v - hi));
}

// keeps the compiler from moving accesses of A fragments that an in-flight
// wgmma reads across this point
template <int kSteps>
__device__ __forceinline__ void fence_frags(uint32_t (&f)[kSteps][8]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+r"(f[s][i])::"memory");
}

// d (64 x 128, fp32) += A (64 x 8, four registers a thread) B^T (128 x 8,
// shared memory, K-major), or = with scale_d 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// The dgates as wgmma's A operand from registers (kernels 8 and 9): kernel
// 4's (T, R, 4H) output read in place. The producer's TMA brings a tile of
// kDgK k rows (rows r of one step) by 128 gates as four boxes of kDgSub
// gates (128 bytes a k row, 128-byte swizzled, kDgSubBytes apart), and each
// consumer thread reads its fragments column-wise out of it, which
// transposes them, and splits them into their TF32 halves itself.
constexpr int kDgK = 32, kDgSub = 32, kDgSubBytes = kDgK * kDgSub * 4, kDgSteps = kDgK / 8;

// A consumer thread's view of a dgates tile. Its A fragment rows of
// wgmma m64nNk8 .tf32 are row 16 warp + g + 8h of its warpgroup's 64, h =
// 0, 1, g = lane / 4; register i of a k8 slice is row h = i & 1, column k
// = q + 4 (i >> 1), q = lane % 4. Row (warp, h, g) holds gate
//
//   32 sub + 4 chunk + (g & 3),  c = 2 warp + h, sub = 2 wg + (c >> 2),
//                                chunk = 4 (g >> 2) + (c & 3),
//
// a bijection onto the warpgroup's 64 gates (boxes 2 wg and 2 wg + 1, 8
// 16-byte chunks a box). Under the 128-byte swizzle chunk ch of k row k
// lies at ch ^ (k & 7), so the bank of a read is 4 (chunk ^ (k & 7)) +
// (g & 3). For one register i, k & 7 = q + 4 (i >> 1): chunk ^ (k & 7)
// takes bit 2 from g >> 2 and bits 0-1 from (c & 3) ^ q, so the 32 lanes
// (g, q) read 32 distinct banks.
struct DgatesReader {
  int gate[2];  // of rows h = 0, 1, within the tile
  int off[4];   // byte offset of register i's value in slice 0; slice s is 1024 s further

  __device__ __forceinline__ DgatesReader(int wg, int warp, int lane) {
    const int g = lane / 4, q = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * warp + h, sub = 2 * wg + (c >> 2), chunk = 4 * (g >> 2) + (c & 3);
      gate[h] = kDgSub * sub + 4 * chunk + (g & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = q + 4 * half;
        off[2 * half + h] = sub * kDgSubBytes + k * 128 + ((chunk ^ k) << 4) + (g & 3) * 4;
      }
    }
  }

  // the fragments of the k-block in ``a``, split: f[s][0..3] the big halves
  // of slice s, f[s][4..7] the small ones
  __device__ __forceinline__ void load_split(uint32_t (&f)[kDgSteps][8], const uint8_t* a) const {
#pragma unroll
    for (int s = 0; s < kDgSteps; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = *reinterpret_cast<const float*>(a + off[i] + s * 8 * 128);
        f[s][i] = tf32(v);
        f[s][4 + i] = tf32(v - __uint_as_float(f[s][i]));
      }
  }
};

// cuTensorMapEncodeTiled, taken from the driver at run time, so that the
// libraries need no link to libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// a (rows, cols) row-major matrix of ``elem_bytes``-byte elements read in
// (box_rows x box_cols) boxes, box_cols * elem_bytes = 128: one swizzle row;
// the boxes' elements past the matrix's edges read as zero
inline bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem_bytes, int rows,
                     int cols, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 3-D fp32 tensor of dims (d0, d1, d2), d0 contiguous, dims 1 and 2
// ``s1`` and ``s2`` bytes apart, read in (b0, b1, b2) boxes, b0 * 4 = 128:
// one swizzle row; the boxes' elements past its edges read as zero
inline bool make_map_3d(CUtensorMap* map, const void* base, int d0, int d1, int d2, long long s1, long long s2,
                        int b0, int b1, int b2) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace tma_gemm
