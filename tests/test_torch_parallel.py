"""The port's multi-device rules against the JAX package's ``parallel``.

In one process, no group:

* ``leaf_spec``, ``zero_leaf_spec`` and the batch rows of
  ``process_batch_bounds`` equal the JAX functions' on the same shapes
  (``dualvgr_tpu/parallel/tp.py:69,84``, ``mesh.py:115``), the error for a
  batch the data axis does not divide included;
* at the flagship width, every element of every parameter lies on the same
  rank under the port's TP and ZeRO placement as under the JAX spec of its
  leaf, the JAX leaves taken to the port's tensors through
  ``utils/weights.py``'s re-layout (owner ids carried through
  ``reference_state_dict``);
* ``tensor_parallel: 2`` builds a model with the kernels off and logs the
  JAX package's warning, as the JAX config does;
* without a launcher's environment ``maybe_initialize_distributed`` does
  nothing, ``mesh_for`` gives no mesh (and refuses ``tensor_parallel``
  > 1), and ``place_state`` leaves the state as it is.

The multi-rank steps are in ``tests/test_torch_multiprocess.py``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualvgr_tpu import config as jconfig
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.parallel import batch_sharding, data_mesh
from dualvgr_tpu.parallel import tp as jtp
from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch import config as tconfig
from dualvgr_tpu_torch.parallel import mesh as tmesh
from dualvgr_tpu_torch.parallel import tp as ttp
from dualvgr_tpu_torch.train_lib import create_train_state, make_optimizer
from dualvgr_tpu_torch.utils.weights import reference_state_dict

FLAGSHIP = dict(vision_dim=2048, module_dim=768, word_dim=300, question_vocab_size=8000, num_answers=4000,
                num_of_nodes=16, graph_layers=1, unit_layers=1)

SHAPES = [(), (1,), (4,), (8,), (16,), (300,), (768,), (1536,), (8000, 300), (300, 1536), (2048, 1536),
          (384, 1536), (768, 1), (4, 384), (768, 4, 192), (4, 192), (7, 24), (12, 36, 3), (30, 16)]


@pytest.mark.parametrize("n_model", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_leaf_spec_matches_jax(shape, n_model):
    assert ttp.leaf_spec(shape, n_model) == tuple(jtp.leaf_spec(shape, n_model))


@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2), (3, 1), (8, 1)])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_zero_leaf_spec_matches_jax(shape, n_data, n_model):
    assert ttp.zero_leaf_spec(shape, n_data, n_model) == tuple(jtp.zero_leaf_spec(shape, n_data, n_model))
    assert ttp.zero_leaf_spec(shape, n_data, n_model, data_axis="batch") == tuple(
        jtp.zero_leaf_spec(shape, n_data, n_model, data_axis="batch"))


@pytest.mark.parametrize("size,global_batch", [(1, 8), (2, 8), (4, 8), (8, 8), (2, 256), (4, 6), (8, 7)])
def test_batch_bounds_match_the_jax_batch_sharding(size, global_batch):
    """Each rank's rows are the rows JAX's batch sharding gives the device
    of that index along a data mesh of ``size``; a batch the axis does not
    divide raises ValueError in both."""
    sharding = batch_sharding(data_mesh(devices=jax.devices()[:size]))
    if global_batch % size:
        with pytest.raises(ValueError):
            sharding.devices_indices_map((global_batch,))
        with pytest.raises(ValueError, match="split evenly"):
            tmesh.batch_bounds(0, size, global_batch)
        return
    rows = sorted((idx[0].start or 0, idx[0].stop or global_batch)
                  for idx in sharding.devices_indices_map((global_batch,)).values())
    assert [tmesh.batch_bounds(i, size, global_batch) for i in range(size)] == rows


def _jax_flagship_shapes():
    model = JaxDualVGR(**FLAGSHIP)
    c, f, t = 16, 16, 8
    example = (jnp.zeros((1, c, f, 2048)), jnp.zeros((1, c, 2048)), jnp.zeros((1, t), jnp.int32),
               jnp.ones((1,), jnp.int32))
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *example, train=False))


def _owner(shape, spec, axis_name, n):
    """int8 array of ``shape``: the index along ``axis_name`` (of size n)
    that holds each element under ``spec``, -1 where it is not sharded."""
    out = np.full(shape, -1, np.int8)
    for i, a in enumerate(spec):
        if a == axis_name:
            idx = np.arange(shape[i]) // (shape[i] // n)
            out[...] = idx.reshape([-1 if j == i else 1 for j in range(len(shape))]).astype(np.int8)
    return out


def _port_owner(param_shape, layout, spec, axis_name, n):
    """The same from the port's side: its tensor's owner ids, from the dim
    (or head) the port shards."""
    d = ttp._torch_dim(layout, spec, axis_name)
    if d is None:
        return np.full(param_shape, -1, np.int8)
    if d == ttp.HEAD:
        per = layout.jax_shape[spec.index(axis_name)] // n
        return np.full(param_shape, layout.head // per, np.int8)
    idx = np.arange(param_shape[d]) // (param_shape[d] // n)
    return np.broadcast_to(idx.reshape([-1 if j == d else 1 for j in range(len(param_shape))]),
                           param_shape).astype(np.int8)


@pytest.fixture(scope="module")
def flagship():
    model = build_model(device="cpu", **FLAGSHIP)
    return model, ttp.jax_layout(model), _jax_flagship_shapes()


@pytest.mark.parametrize("kind,n_data,n_model", [("tp", 1, 2), ("tp", 1, 4), ("zero", 2, 1), ("zero", 2, 2),
                                                 ("zero", 4, 2)])
def test_flagship_placement_matches_jax_through_the_weights_mapping(flagship, kind, n_data, n_model):
    """Every element of every flagship parameter is owned by the same model
    (TP) or data (ZeRO) index as the JAX spec of its leaf puts it on."""
    model, layouts, shapes = flagship
    axis, n = ("model", n_model) if kind == "tp" else ("data", n_data)

    def spec(shape):
        return (jtp.leaf_spec(shape, n_model) if kind == "tp"
                else jtp.zero_leaf_spec(shape, n_data, n_model))

    def owners(tree):
        return jax.tree_util.tree_map(lambda s: _owner(s.shape, tuple(spec(s.shape)), axis, n), tree)

    stats = jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes["batch_stats"])
    want = reference_state_dict({"params": owners(shapes["params"]), "batch_stats": stats})
    sharded = 0
    for name, p in model.named_parameters():
        lay = layouts[name]
        port_spec = (ttp.leaf_spec(lay.jax_shape, n_model) if kind == "tp"
                     else ttp.zero_leaf_spec(lay.jax_shape, n_data, n_model))
        got = _port_owner(tuple(p.shape), lay, port_spec, axis, n)
        np.testing.assert_array_equal(got, want[name], err_msg=name)
        sharded += int((got >= 0).any())
    assert sharded > 0


def test_jax_layout_names_every_parameter_with_its_leaf_size(flagship):
    model, layouts, _ = flagship
    assert set(layouts) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        lay = layouts[name]
        heads = lay.jax_shape[lay.axes.index(ttp.HEAD)] if ttp.HEAD in lay.axes else 1
        assert np.prod(lay.jax_shape) == p.numel() * heads, name


def test_tensor_parallel_turns_the_kernels_off_with_the_jax_warning(caplog):
    """As the JAX config does: with the kernels asked for, tensor_parallel 2
    gives use_kernels False and logs why; the model builds without them."""
    cfg, jcfg = tconfig.default_config(), jconfig.default_config()
    for c in (cfg, jcfg):
        c.tpu.tensor_parallel, c.tpu.use_pallas = 2, True
    with caplog.at_level(logging.WARNING):
        kw = tconfig.model_runtime_kwargs(cfg, "cuda")
    assert kw == {"use_kernels": False, "compute_dtype": "float32"}
    assert "tpu.tensor_parallel=2 forces the plain (non-kernel) execution path" in caplog.text
    assert jconfig.model_runtime_kwargs(jcfg)["use_pallas"] is False
    model = build_model(device="cpu", **dict(FLAGSHIP, module_dim=16, vision_dim=24, word_dim=8), **kw)
    assert model.use_kernels is False
    cfg.tpu.tensor_parallel = 1
    assert tconfig.model_runtime_kwargs(cfg, "cuda")["use_kernels"] is True


def test_one_process_has_no_mesh(monkeypatch):
    for k in tmesh.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert tmesh.maybe_initialize_distributed("cpu") is False
    cfg = tconfig.default_config()
    assert ttp.mesh_for(cfg, "cpu") is None
    cfg.tpu.tensor_parallel = 2
    with pytest.raises(ValueError, match="tensor_parallel=2 does not divide the 1 available devices"):
        ttp.mesh_for(cfg, "cpu")
    model = build_model(device="cpu", **dict(FLAGSHIP, module_dim=16, vision_dim=24, word_dim=8))
    state = create_train_state(model, make_optimizer(1e-3, 10))
    assert ttp.place_state(state, None, zero_opt=True) is state and state.placement is None
    batch = (np.zeros((4, 2)), torch.zeros(4))
    assert tmesh.shard_batch(batch, None) is batch
    assert tmesh.shard_batch_local(batch, None) is batch
    with pytest.raises(ValueError, match="leading dim"):
        tmesh.shard_batch_local((np.zeros((4, 2)), np.zeros(3)), None)
