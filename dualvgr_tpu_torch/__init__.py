"""DualVGR video question answering in PyTorch with hand-written CUDA kernels.

The PyTorch port of the JAX package ``dualvgr_tpu``, which stays beside it
as the reference: the eval forward and its serving path (``build_model``,
``build_predict_fn``, ``BatchingEngine``), the train step
(``make_optimizer``, ``create_train_state``, ``train_step``) and the
validation forward (``pred_step``), in fp32 or with bf16 streaming
(``build_model(compute_dtype="bfloat16")``); the data layer
(``dualvgr_tpu_torch.data``: feature stores, the batch loader, the dataset
checker), validation (``validate_lib``), checkpoints
(``utils.checkpoint``) and the two CLIs, ``python -m
dualvgr_tpu_torch.train`` and ``python -m dualvgr_tpu_torch.validate``;
the deployment path: replicas (``ReplicatedEngine``), the AOT ``.dvgr``
export (``export_serving``, ``load_artifact``; ``python -m
dualvgr_tpu_torch.export``), the HTTP front (``python -m
dualvgr_tpu_torch.serve``) and the checkpoint interchange with the
reference (``python -m dualvgr_tpu_torch.utils.port_reference``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``); there is no fallback from one to the
other.
"""

from dualvgr_tpu_torch.models.dualvgr import DualVGR, DualVGROutput, build_model
from dualvgr_tpu_torch.export import export_serving, load_artifact
from dualvgr_tpu_torch.serving import BatchingEngine, ReplicatedEngine, build_predict_fn
from dualvgr_tpu_torch.train_lib import (
    TrainState, create_train_state, make_lr_schedule, make_optimizer, pred_step, reset_grad_accum, set_glove,
    train_step,
)

__all__ = [
    "BatchingEngine", "DualVGR", "DualVGROutput", "ReplicatedEngine", "TrainState", "build_model",
    "build_predict_fn", "create_train_state", "export_serving", "load_artifact", "make_lr_schedule",
    "make_optimizer", "pred_step", "reset_grad_accum", "set_glove", "train_step",
]
