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
// On the TPU the grid is (row_blocks, T) and h/c live in VMEM scratch
// across the sequential T axis. Here the design is bilstm_cluster.cuh's,
// shared with kernel 3: W_hh resident in the shared memory of a thread-block
// cluster for the whole launch, persistent clusters walking (direction, row
// tile) items over all T steps, h exchanged through distributed shared
// memory with one cluster barrier per step. What bounds it is written there:
// the recurrent product is fp32 FMA work on the CUDA cores, 2*T*R*H*4H*2
// flops, about 155 GFLOP for the appearance encoder (T=16, R=4096, H=384),
// 2.3 ms at 67 TFLOP/s; the gate bytes are an order of magnitude below.

#include "bilstm_cluster.cuh"

namespace {

using bilstm_cluster::Params;

template <typename TG>
cudaError_t launch_as(const Params& p, int cluster, void* stream) {
  return bilstm_cluster::launch<TG, TG, false>(p, cluster, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `outs` may be null.
// gate_dtype: 0 for fp32 gates, final and outs; 1 for bf16. cluster, units,
// rows_per_tile and clusters are the plan of ops/lstm_kernel.py::
// recurrence_plan; a plan this build cannot run returns
// cudaErrorInvalidValue. Returns the cudaError_t of the launch (0 =
// cudaSuccess); a cluster the card refuses returns its error.
extern "C" int bilstm_recurrence_launch(const void* xf, const void* xb, const void* whf,
                                        const void* whb, const void* lengths, void* final_out,
                                        void* outs, int T, int R, int H, int gate_dtype, int cluster,
                                        int units, int rows_per_tile, int clusters, void* stream) {
  if ((gate_dtype != 0 && gate_dtype != 1) ||
      !bilstm_cluster::check_plan(T, R, H, cluster, units, rows_per_tile, clusters))
    return (int)cudaErrorInvalidValue;
  const Params p{xf, xb, static_cast<const float*>(whf), static_cast<const float*>(whb),
                 static_cast<const int*>(lengths), final_out, outs, nullptr, nullptr,
                 T, R, H, units, (R + rows_per_tile - 1) / rows_per_tile, clusters};
  const cudaError_t err = gate_dtype == 1 ? launch_as<__nv_bfloat16>(p, cluster, stream)
                                          : launch_as<float>(p, cluster, stream);
  return (int)err;
}

// How many clusters of `cluster` CTAs of `units` hidden units the card
// holds at once at hidden size H (cudaOccupancyMaxActiveClusters), or minus
// the cudaError_t.
extern "C" int bilstm_recurrence_active_clusters(int H, int cluster, int units, int gate_dtype) {
  int count = 0;
  const cudaError_t err = gate_dtype == 1
      ? bilstm_cluster::active_clusters<__nv_bfloat16, __nv_bfloat16, false>(H, cluster, units, &count)
      : bilstm_cluster::active_clusters<float, float, false>(H, cluster, units, &count);
  return err == cudaSuccess ? count : -(int)err;
}

// The dynamic shared memory of one CTA at hidden size H with `cluster` CTAs
// of `units` hidden units, as the launch asks for it.
extern "C" int bilstm_recurrence_smem_bytes(int H, int cluster, int units) {
  return bilstm_cluster::smem_bytes(H, cluster * units);
}

