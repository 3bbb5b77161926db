"""The port's 3D CNN zoo (``models/backbones/resnet3d_zoo.py``) against the
JAX package's flax zoo, on the CPU. Seeded flax variables (BatchNorm leaves
redrawn) go across with ``utils/weights.py::backbone_from_flax``:

* forwards, outputs within 1e-4 x max|ref| (fp32): the two shallow
  constructors (``resnet3d_10``, ``resnet3d_18``) at a reduced input size,
  and each block type (basic, bottleneck, wide, pre-activation, dense;
  shortcuts A and B) in a network of reduced depth;
* every constructor: the same state_dict shapes as the flax variables fill,
  loaded with ``strict=True`` (a forward of the deep ones is XLA compile
  time on the CPU, not coverage).
"""

import numpy as np
import pytest
import torch

import jax

from dualvgr_tpu.models.backbones import resnet3d_zoo as jz
from dualvgr_tpu_torch.models.backbones import resnet3d_zoo as tz
from dualvgr_tpu_torch.utils.weights import backbone_from_flax

from test_torch_backbones import seeded_variables

TOL = 1e-4

RUN = [
    ("resnet3d_10", {}),
    ("resnet3d_18", {}),
    ("resnet3d_10", {"shortcut_type": "A"}),
    ("ResNet3D", {"layers": (1, 1, 1, 1)}),
    ("ResNet3D", {"layers": (1, 2, 1, 1), "shortcut_type": "A"}),
    ("ResNet3D", {"layers": (1, 1, 1, 1), "widen": 2}),
    ("ResNet3D", {"layers": (1, 2, 1, 1), "block": "preact_bottleneck"}),
    ("DenseNet3D", {"block_config": (1, 2, 1), "growth_rate": 8, "num_init_features": 16}),
]
STRUCTURE = ["resnet3d_10", "resnet3d_18", "resnet3d_34", "resnet3d_50", "resnet3d_101", "resnet3d_152",
             "resnet3d_200", "wide_resnet3d_50", "pre_act_resnet3d_50", "pre_act_resnet3d_101", "densenet3d_121",
             "densenet3d_169", "densenet3d_201", "densenet3d_264"]


def _input(name):
    # the average pools of DenseNet's transitions need 8 frames for two
    shape = (1, 3, 8, 16, 16) if name == "DenseNet3D" else (1, 3, 4, 16, 16)
    return np.random.RandomState(0).rand(*shape).astype(np.float32)


def _channels_last(x):
    return x.transpose(0, 2, 3, 4, 1)


@pytest.mark.parametrize("name,kw", RUN, ids=[f"{n}{'-' + '-'.join(map(str, k.values())) if k else ''}"
                                              for n, k in RUN])
def test_zoo_network_matches_flax(name, kw):
    x = _input(name)
    jm = getattr(jz, name)(**kw)
    v = seeded_variables(jm, _channels_last(x), 2)
    want = np.asarray(jm.apply(v, _channels_last(x)))
    tm = getattr(tz, name)(**kw).eval()
    tm.load_state_dict(backbone_from_flax(v), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    if kw.get("shortcut_type") == "A":
        assert not any("downsample" in k for k in tm.state_dict())


@pytest.mark.parametrize("name", STRUCTURE)
def test_deep_zoo_constructors_take_the_flax_variables(name):
    jm = getattr(jz, name)()
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), np.zeros(_channels_last(_input(name)).shape,
                                                                          np.float32)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tm = getattr(tz, name)()
    sd = backbone_from_flax(zeros)
    tm.load_state_dict(sd, strict=True)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
