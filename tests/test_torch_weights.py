"""``from_jax_variables`` against the JAX package's reference export.

The port's weight bridge must give, key for key and value for value, the
state_dict ``dualvgr_tpu.utils.port_reference.export_reference_state_dict``
gives (the names a reference ``*_model.pt`` carries), and that state_dict
must fill every parameter and buffer of the port's model.
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.utils.port_reference import export_reference_state_dict
from dualvgr_tpu_torch import build_model
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import dims, inputs, random_variables


@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 2)])
def test_matches_reference_export_and_fills_model(unit_layers, graph_layers):
    kw = dims(unit_layers, graph_layers, 4)
    variables = random_variables(JaxDualVGR(**kw), inputs(4))
    want = export_reference_state_dict(variables)
    got = from_jax_variables(variables)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

    model = build_model(device="cpu", **kw)
    assert sorted(model.state_dict()) == sorted(got)
    model.load_state_dict(got, strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k].numpy(), err_msg=k)


def test_compute_dtype_changes_no_state_dict_key():
    """A bf16 model has the fp32 model's parameters and state_dict keys, and
    ``from_jax_variables`` loads it strictly."""
    kw = dims(1, 1, 4)
    variables = random_variables(JaxDualVGR(**kw), inputs(4))
    fp32 = build_model(device="cpu", **kw)
    bf16 = build_model(device="cpu", compute_dtype="bfloat16", **kw)
    assert bf16.compute_dtype == "bfloat16" and fp32.compute_dtype == "float32"
    s32, s16 = fp32.state_dict(), bf16.state_dict()
    assert list(s32) == list(s16)
    assert all(torch.equal(s32[k], s16[k]) and s32[k].dtype == s16[k].dtype for k in s32)
    bf16.load_state_dict(from_jax_variables(variables), strict=True)
