"""The data layer: question pickles and clip-feature stores to batches."""

from dualvgr_tpu_torch.data.features import FeatureStore  # noqa: F401
from dualvgr_tpu_torch.data.loader import Batch, VideoQADataLoader  # noqa: F401
from dualvgr_tpu_torch.data.vocab import load_vocab  # noqa: F401
