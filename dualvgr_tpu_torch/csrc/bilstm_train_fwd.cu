// Training forward of the bidirectional LSTM recurrence, with residuals: fp32
// arithmetic over fp32 or bf16 gates.
//
// Replaces the TPU kernel dualvgr_tpu/ops/lstm_pallas_train.py::_run_fwd_m
// (kernel body `_fwd_kernel_m`). It computes what the eval recurrence
// (bilstm_recurrence.cu) computes: xf (T, R, 4H) forward gates, xb (T, R, 4H)
// backward gates already time-reversed, W_hh (H, 4H) per direction, gate
// order i, f, g, o, optional packed lengths, optional zero-masked per-step
// outputs (R, T, 2H) with the backward half back in original time order,
// final state (R, 2H) = [h_fwd at len-1, h_bwd at t=0]. Besides, it stores
// the state each step starts from, (h_{t-1}, c_{t-1}), into hprev and cprev
// (T, R, 2H) in kernel time, [fwd | bwd] on the last axis, and the gate
// activations (sigmoid i, sigmoid f, tanh g, sigmoid o) of every step into
// acts (2, T, R, 4H), direction-major, each half in kernel time and the
// gates' layout, zero at a masked step. The backward kernel
// (bilstm_train_bwd.cu) reads the activations and c_{t-1} instead of
// running the gate product a second time; hprev serves dW_hh outside. The
// gates may be bf16 (the appearance op under compute_dtype: bfloat16,
// lstm_pallas_train.py:392-405): read as bf16 and widened; everything
// written (final, outs, the residuals, the activations) is fp32 either
// way, as in the TPU kernel.
//
// Design: the eval kernel's, bilstm_cluster.cuh (W_hh resident in a
// thread-block cluster, h exchanged through distributed shared memory). The
// thread that updates a (row, unit) pair stores its residuals and
// activations, coalesced across the units of a row. Bound on the H100: the
// recurrent product is fp32 FMA work on the CUDA cores, about 155 GFLOP
// for the appearance encoder (T=16, R=4096, H=384), 2.3 ms at 67 TFLOP/s;
// the residuals add 2 x 201 MB of stores at that shape and the activations
// 805 MB, 0.36 ms of HBM time together, so the kernel stays bound by
// operations.

#include "bilstm_cluster.cuh"

namespace {

using bilstm_cluster::Params;

template <typename TG>
cudaError_t launch_as(const Params& p, int cluster, void* stream) {
  return bilstm_cluster::launch<TG, float, true>(p, cluster, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C entry for ctypes. `lengths` (int32, R) and `outs` may be null.
// gate_dtype: 0 for fp32 gates, 1 for bf16. The plan's numbers and the
// return value as in bilstm_recurrence_launch.
extern "C" int bilstm_train_fwd_launch(const void* xf, const void* xb, const void* whf,
                                       const void* whb, const void* lengths, void* final_out,
                                       void* outs, void* hprev, void* cprev, void* acts, int T, int R,
                                       int H, int gate_dtype, int cluster, int units, int rows_per_tile,
                                       int clusters, void* stream) {
  if ((gate_dtype != 0 && gate_dtype != 1) ||
      !bilstm_cluster::check_plan(T, R, H, cluster, units, rows_per_tile, clusters))
    return (int)cudaErrorInvalidValue;
  const Params p{xf, xb, static_cast<const float*>(whf), static_cast<const float*>(whb),
                 static_cast<const int*>(lengths), final_out, outs, static_cast<float*>(hprev),
                 static_cast<float*>(cprev), T, R, H, units, (R + rows_per_tile - 1) / rows_per_tile,
                 clusters, static_cast<float*>(acts)};
  const cudaError_t err = gate_dtype == 1 ? launch_as<__nv_bfloat16>(p, cluster, stream)
                                          : launch_as<float>(p, cluster, stream);
  return (int)err;
}

// As bilstm_recurrence_active_clusters, for this kernel.
extern "C" int bilstm_train_fwd_active_clusters(int H, int cluster, int units, int gate_dtype) {
  int count = 0;
  const cudaError_t err = gate_dtype == 1
      ? bilstm_cluster::active_clusters<__nv_bfloat16, float, true>(H, cluster, units, &count)
      : bilstm_cluster::active_clusters<float, float, true>(H, cluster, units, &count);
  return err == cudaSuccess ? count : -(int)err;
}

// As bilstm_recurrence_smem_bytes, for this kernel.
extern "C" int bilstm_train_fwd_smem_bytes(int H, int cluster, int units) {
  return bilstm_cluster::smem_bytes(H, cluster * units);
}

