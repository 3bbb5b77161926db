"""DualVGR video question answering in PyTorch with hand-written CUDA kernels.

The PyTorch port of the JAX package ``dualvgr_tpu``, which stays beside it
as the reference. Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; there is no fallback from one to the other.
"""

from dualvgr_tpu_torch.models.dualvgr import DualVGR, DualVGROutput, build_model
from dualvgr_tpu_torch.serving import BatchingEngine, build_predict_fn

__all__ = ["BatchingEngine", "DualVGR", "DualVGROutput", "build_model", "build_predict_fn"]
