"""The BiLSTM and graph-cycle ops: plain PyTorch versions and CUDA kernels.

``COUNTED_KERNELS`` are the wrappers of the hand-written kernels, kernels
1-6, the tanh pass, then kernels 7, 8 and 9; each counts its launches in
``.launches``.
"""

from dualvgr_tpu_torch.ops.gat_kernel import gat_cycle
from dualvgr_tpu_torch.ops.lstm_kernel import bilstm_recurrence
from dualvgr_tpu_torch.ops.lstm_train_kernel import bilstm_train_bwd, bilstm_train_fwd
from dualvgr_tpu_torch.ops.proj_kernel import (
    input_proj_both, input_proj_f32, input_proj_f32_wgrad, input_proj_one, tanh_to_bf16,
)
from dualvgr_tpu_torch.ops.whh_grad_kernel import whh_grad_f32

COUNTED_KERNELS = (bilstm_recurrence, gat_cycle, bilstm_train_fwd, bilstm_train_bwd, input_proj_one,
                   input_proj_both, tanh_to_bf16, input_proj_f32, input_proj_f32_wgrad, whh_grad_f32)


def launch_counts() -> tuple:
    """Launches of kernels 1-6, of the tanh pass and of kernels 7-9, as their wrappers count them."""
    return tuple(k.launches for k in COUNTED_KERNELS)
