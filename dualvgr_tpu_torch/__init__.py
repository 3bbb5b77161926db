"""DualVGR video question answering in PyTorch with hand-written CUDA kernels.

The PyTorch port of the JAX package ``dualvgr_tpu``, which stays beside it
as the reference: the eval forward and its serving path (``build_model``,
``build_predict_fn``, ``BatchingEngine``) and the train step
(``make_optimizer``, ``create_train_state``, ``train_step``), in fp32 or
with bf16 streaming (``build_model(compute_dtype="bfloat16")``). Entry
points run on the CUDA device unless the caller passes ``device="cpu"``;
there is no fallback from one to the other.
"""

from dualvgr_tpu_torch.models.dualvgr import DualVGR, DualVGROutput, build_model
from dualvgr_tpu_torch.serving import BatchingEngine, build_predict_fn
from dualvgr_tpu_torch.train_lib import (
    TrainState, create_train_state, make_lr_schedule, make_optimizer, reset_grad_accum, set_glove,
    train_step,
)

__all__ = [
    "BatchingEngine", "DualVGR", "DualVGROutput", "TrainState", "build_model", "build_predict_fn",
    "create_train_state", "make_lr_schedule", "make_optimizer", "reset_grad_accum", "set_glove",
    "train_step",
]
