"""The feature-extraction backbones: ResNet-101 (appearance), ResNeXt-101 3D
(motion) and the reference's 3D CNN zoo."""

from dualvgr_tpu_torch.models.backbones.resnet2d import ResNet101, port_resnet101_state_dict  # noqa: F401
from dualvgr_tpu_torch.models.backbones.resnext3d import ResNeXt101_3D, port_resnext101_state_dict  # noqa: F401
