"""The port's feature-extraction backbones against the JAX package's flax ones.

Seeded flax variables (every BatchNorm statistic and affine redrawn, so
none sits at its init value) go across with ``utils/weights.py::
resnet101_from_flax`` / ``resnext101_from_flax`` into the port's NCHW /
NCDHW modules, and the same numpy inputs go through both, on the CPU, at
``layers=(1, 1, 1, 1)``: features within 1e-4 x max|ref| (fp32; only the
conv sum order differs). Also:

* every ``max_stages`` 0-4 of ResNeXt-101 3D, and its grouped conv run
  grouped and block-diagonal;
* bf16 against fp32 within the JAX package's own limits
  (``tests/test_preprocess_e2e.py``: relative norm error < 0.02, per-row
  cosine > 0.995), the output fp32;
* a torchvision-layout state_dict (the port's own keys, plus ``fc.*``)
  round-trips through the JAX package's ``port_resnet101_state_dict`` and
  back and loads with ``strict=True``; likewise a ``module.``-prefixed
  Kinetics dict through ``port_resnext101_state_dict``.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from dualvgr_tpu.models.backbones import resnet2d as jax_r2d
from dualvgr_tpu.models.backbones import resnext3d as jax_x3d
from dualvgr_tpu_torch.models.backbones import resnext3d
from dualvgr_tpu_torch.models.backbones.resnet2d import ResNet101, port_resnet101_state_dict
from dualvgr_tpu_torch.models.backbones.resnext3d import (
    GroupedConv3D, ResNeXt101_3D, blockdiag_weight, port_resnext101_state_dict,
)
from dualvgr_tpu_torch.utils.weights import resnet101_from_flax, resnext101_from_flax

LAYERS = (1, 1, 1, 1)
TOL = 1e-4  # x max|ref|
BF16_REL_NORM, BF16_COS = 0.02, 0.995


def seeded_variables(model, example, seed):
    """flax variables with the BatchNorm leaves redrawn from numpy."""
    v = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(seed), example))
    rng = np.random.RandomState(seed)

    def redraw(path, a):
        name = path[-1].key
        if name == "var":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        if name in ("mean", "bias"):
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.randn(*a.shape) * 0.1).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(redraw, v)


@functools.lru_cache(maxsize=None)
def jax_resnet2d():
    x = np.random.RandomState(0).rand(2, 3, 32, 32).astype(np.float32) * 255
    model = jax_r2d.ResNet101(layers=LAYERS)
    v = seeded_variables(model, x.transpose(0, 2, 3, 1), 0)
    return v, x, np.asarray(model.apply(v, x.transpose(0, 2, 3, 1)))


@functools.lru_cache(maxsize=None)
def jax_resnext3d(max_stages=4):
    x = np.random.RandomState(1).rand(2, 3, 16, 32, 32).astype(np.float32) * 255  # raw pixels
    model = jax_x3d.ResNeXt101_3D(layers=LAYERS, max_stages=max_stages)
    v = seeded_variables(model, x.transpose(0, 2, 3, 4, 1), 1)
    return v, x, np.asarray(model.apply(v, x.transpose(0, 2, 3, 4, 1)))


def close(got, want, tol=TOL):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def port_resnet(v, **kw):
    m = ResNet101(layers=LAYERS, **kw).eval()
    m.load_state_dict(resnet101_from_flax(v), strict=True)
    return m


def port_resnext(v, **kw):
    m = ResNeXt101_3D(layers=LAYERS, **kw).eval()
    m.load_state_dict(resnext101_from_flax(v), strict=True)
    return m


def test_resnet101_matches_flax():
    v, x, want = jax_resnet2d()
    with torch.no_grad():
        got = port_resnet(v)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    close(got, want)


@pytest.mark.parametrize("impl", ["grouped", "blockdiag", "auto"])
def test_resnext101_3d_matches_flax(impl):
    v, x, want = jax_resnext3d()
    with torch.no_grad():
        got = port_resnext(v, conv2_impl=impl)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    close(got, want)


@pytest.mark.parametrize("max_stages", [0, 1, 2, 3, 4])
def test_resnext101_3d_max_stages_match_flax(max_stages):
    v, x, want = jax_resnext3d(max_stages)
    with torch.no_grad():
        got = port_resnext(v, max_stages=max_stages)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, (64, 256, 512, 1024, 2048)[max_stages])
    close(got, want)


def _bf16_close(got, want):
    got, want = got.astype(np.float64), want.astype(np.float64)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert rel < BF16_REL_NORM and cos.min() > BF16_COS, (rel, cos.min())


def test_bf16_backbones_agree_with_fp32():
    v, x, _ = jax_resnet2d()
    with torch.no_grad():
        a32 = port_resnet(v)(torch.from_numpy(x))
        a16 = port_resnet(v, compute_dtype="bfloat16")(torch.from_numpy(x))
    assert a16.dtype == torch.float32
    _bf16_close(a16.numpy(), a32.numpy())
    v, x, _ = jax_resnext3d()
    with torch.no_grad():
        m32 = port_resnext(v)(torch.from_numpy(x))
        m16 = port_resnext(v, compute_dtype="bfloat16")(torch.from_numpy(x))
    assert m16.dtype == torch.float32
    _bf16_close(m16.numpy(), m32.numpy())


def test_a_torchvision_state_dict_round_trips_and_loads_strictly():
    torch.manual_seed(3)
    src = ResNet101(layers=LAYERS).eval()
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    for k, v in sd.items():  # no BatchNorm at its init value
        if k.endswith(("running_var", "weight")) and v.dim() == 1:
            v.uniform_(0.5, 1.5)
        elif k.endswith(("running_mean", "bias")):
            v.normal_(0, 0.1)
    tv = dict(sd, **{"fc.weight": torch.randn(1000, 2048), "fc.bias": torch.randn(1000)})
    back = resnet101_from_flax(jax_r2d.port_resnet101_state_dict(tv, layers=LAYERS))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    m = ResNet101(layers=LAYERS).eval()
    m.load_state_dict(port_resnet101_state_dict(tv), strict=True)
    x = torch.rand(1, 3, 32, 32) * 255
    with torch.no_grad():
        src.load_state_dict(sd)
        assert torch.equal(m(x), src(x))


def test_a_kinetics_state_dict_round_trips_and_loads_strictly():
    torch.manual_seed(4)
    sd = ResNeXt101_3D(layers=LAYERS).state_dict()
    kin = {"module." + k: v for k, v in sd.items()}
    kin.update({"module.fc.weight": torch.randn(400, 2048), "module.fc.bias": torch.randn(400)})
    back = resnext101_from_flax(jax_x3d.port_resnext101_state_dict(kin, layers=LAYERS))
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    ResNeXt101_3D(layers=LAYERS).load_state_dict(port_resnext101_state_dict(kin), strict=True)


@pytest.mark.parametrize("channels,stride", [(64, 1), (64, 2), (128, 1)])
def test_the_block_diagonal_conv_is_the_grouped_conv(channels, stride):
    torch.manual_seed(5)
    x = torch.randn(2, channels, 4, 6, 6)
    conv = GroupedConv3D(channels, 32, stride, impl="grouped")
    want = conv(x)
    conv.impl = "blockdiag"
    got = conv(x)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    dense = blockdiag_weight(conv.weight, 32)
    assert dense.shape == (channels, channels, 3, 3, 3)
    w_in = channels // 32
    mask = torch.block_diag(*[torch.ones(w_in, w_in)] * 32).bool()
    assert (dense.abs().sum((2, 3, 4))[~mask] == 0).all()


def test_auto_takes_the_listed_block_diagonal_shapes(monkeypatch):
    conv = GroupedConv3D(128, 32, 1)
    monkeypatch.setattr(resnext3d, "BLOCKDIAG_SHAPES", frozenset({("bfloat16", 128, 1)}))
    assert conv.resolved_impl(torch.bfloat16) == "blockdiag"
    assert conv.resolved_impl(torch.float32) == "grouped"
    assert GroupedConv3D(128, 32, 2).resolved_impl(torch.bfloat16) == "grouped"
    with pytest.raises(ValueError):
        GroupedConv3D(128, 32, 1, impl="dense")


def _conv_hook_flops(model, shape):
    """2 x MACs of every conv of ``model`` on one input of ``shape``, from
    the shapes a forward on the meta device gives (no arithmetic runs)."""
    from dualvgr_tpu_torch.models.backbones.resnet2d import TypedConv

    total, inputs = [0], []

    def hook(mod, inp, out):
        total[0] += 2 * (out.numel() // out.shape[0]) * mod.weight[0].numel()
        if isinstance(mod, GroupedConv3D):
            inputs.append((mod.weight.shape[0], mod.stride[0], tuple(inp[0].shape[1:])))

    for mod in model.modules():
        if isinstance(mod, TypedConv):
            mod.register_forward_hook(hook)
    model.to("meta")(torch.empty((1, *shape), device="meta"))
    return total[0], inputs


@pytest.mark.parametrize("layers,hw", [((3, 4, 23, 3), (224, 224)), ((1, 2, 1, 1), (64, 48)), ((2, 1, 3, 1), (33, 57))])
def test_the_resnet101_flop_count_is_its_convs(layers, hw):
    from dualvgr_tpu_torch.utils.flops import resnet101_flops

    want, _ = _conv_hook_flops(ResNet101(layers=layers), (3, *hw))
    assert resnet101_flops(*hw, layers=layers) == want


@pytest.mark.parametrize("layers,thw,max_stages", [((3, 4, 23, 3), (16, 112, 112), 4), ((1, 2, 1, 1), (16, 48, 40), 4),
                                                   ((1, 1, 2, 1), (8, 32, 32), 2)])
def test_the_resnext101_3d_flop_count_is_its_convs(layers, thw, max_stages):
    from dualvgr_tpu_torch.bench.extraction_bench import grouped_shapes
    from dualvgr_tpu_torch.utils.flops import resnext101_3d_flops

    model = ResNeXt101_3D(layers=layers, max_stages=max_stages)
    want, inputs = _conv_hook_flops(model, (3, *thw))
    assert resnext101_3d_flops(*thw, layers=layers, max_stages=max_stages) == want
    grouped = sum(2 * c * (c // 32) * 27 * int(np.prod([(n - 1) // s + 1 for n in shp[1:]]))
                  for c, s, shp in inputs)
    dense = sum(2 * c * c * 27 * int(np.prod([(n - 1) // s + 1 for n in shp[1:]])) for c, s, shp in inputs)
    assert resnext101_3d_flops(*thw, layers=layers, max_stages=max_stages, blockdiag=True) == want - grouped + dense
    if thw == (16, 112, 112):  # the bench's A/B shapes are the network's grouped convs at the flagship
        assert sorted({(c, s, shp) for c, s, shp in inputs}) == sorted(
            (c, s, tuple(shp[1:])) for c, s, shp in grouped_shapes(1))
