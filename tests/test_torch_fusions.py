"""The port's fusion zoo against the JAX package's, on the CPU.

Every fusion of ``FUSIONS`` (through ``fusion_factory``), ``MLP`` and the
options that change the arithmetic (power normalization, shared
projections, the normalization after the concatenation, 3-D inputs to
ConcatMLP): flax params redrawn from numpy and carried across by
``load_flax_params``, the same numpy inputs, outputs within 1e-5. MCB runs
with the JAX package's hash and sign vectors, carried across as the count
sketches' buffers. The port's fusions take the reference's ``input_dims``,
which flax infers.
"""

import jax
import numpy as np
import pytest
import torch

from dualvgr_tpu.models import fusions as JF
from dualvgr_tpu_torch.models import fusions as PF

from test_torch_zoo import assert_tree_close, run_pair

D0, D1, OUT = 10, 12, 24

# name -> (factory kwargs shared by both, extra port kwargs)
CASES = {
    "block": dict(mm_dim=40, chunks=4, rank=3),
    "block_shared_after_cat": dict(mm_dim=40, chunks=3, rank=2, shared=True, pos_norm="after_cat"),
    "block_tucker": dict(mm_dim=40, chunks=4),
    "block_tucker_after_cat": dict(mm_dim=18, chunks=4, pos_norm="after_cat"),
    "mutan": dict(mm_dim=16, rank=3),
    "mutan_shared_normalized": dict(mm_dim=16, rank=3, shared=True, normalize=True),
    "tucker": dict(mm_dim=16),
    "tucker_normalized": dict(mm_dim=16, normalize=True),
    "mlb": dict(mm_dim=7, normalize=True),
    "mfb": dict(mm_dim=8, factor=3),
    "mfb_normalized": dict(mm_dim=8, normalize=True),
    "mfh": dict(mm_dim=8),
    "mfh_normalized": dict(mm_dim=8, normalize=True, activ_output="tanh"),
    "mcb": dict(mm_dim=64),
    "linear_sum": dict(mm_dim=20),
    "linear_sum_normalized": dict(mm_dim=20, normalize=True, activ_input="tanh"),
    "cat_mlp": dict(dimensions=(16, 12)),
}


def _shared_dims(name):
    # shared projections serve both inputs: one input size
    return (D0, D0) if "shared" in name else (D0, D1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fusion_matches_flax(case):
    name = case.split("_")[0] if case.split("_")[0] in PF.FUSIONS else "_".join(case.split("_")[:2])
    kw = dict(CASES[case], output_dim=OUT)
    dims = _shared_dims(case)
    rng = np.random.RandomState(0)
    args = (rng.randn(3, dims[0]).astype(np.float32), rng.randn(3, dims[1]).astype(np.float32))
    extra = None
    if name == "mcb":
        extra = {}
        for i, d in enumerate(dims):
            sketch = JF.CountSketch(d, kw["mm_dim"], seed=i).bind({})
            extra[f"sketch{i}.h"] = np.asarray(sketch.h).astype(np.int64)
            extra[f"sketch{i}.s"] = np.asarray(sketch.s)
    got, want, _ = run_pair(JF.fusion_factory(name, **kw), PF.fusion_factory(name, input_dims=dims, **kw), args,
                            extra=extra)
    assert tuple(got.shape) == (3, OUT)
    assert_tree_close(got, want, case)


def test_cat_mlp_broadcasts_a_2d_input_over_3d():
    rng = np.random.RandomState(1)
    args = (rng.randn(3, 5, D0).astype(np.float32), rng.randn(3, D1).astype(np.float32))
    got, want, _ = run_pair(JF.ConcatMLP(OUT, dimensions=(8,)), PF.ConcatMLP((D0, D1), OUT, dimensions=(8,)),
                            args)
    assert_tree_close(got, want, "cat_mlp 3d")


def test_mlp_matches_flax():
    rng = np.random.RandomState(2)
    got, want, _ = run_pair(JF.MLP((8, 6, 4), activation="tanh"), PF.MLP(D0, (8, 6, 4), activation="tanh"),
                            (rng.randn(3, D0).astype(np.float32),))
    assert_tree_close(got, want, "mlp")


def test_factory_registry_and_helpers():
    assert sorted(PF.FUSIONS) == sorted(JF.FUSIONS)
    with pytest.raises(ValueError, match="unknown fusion"):
        PF.fusion_factory("nope", input_dims=(2, 2), output_dim=3)
    for dim, chunks in ((1600, 20), (10, 3), (40, 7), (7, 7)):
        assert PF.get_sizes_list(dim, chunks) == JF.get_sizes_list(dim, chunks)
    z = np.random.RandomState(3).randn(4, 9).astype(np.float32)
    np.testing.assert_allclose(PF.power_normalize(torch.from_numpy(z)).numpy(),
                               np.asarray(JF.power_normalize(jax.numpy.asarray(z))), rtol=1e-6, atol=1e-7)


def test_count_sketch_is_seeded_and_on_the_input_device():
    a, b = PF.CountSketch(10, 32, seed=0), PF.CountSketch(10, 32, seed=0)
    assert torch.equal(a.h, b.h) and torch.equal(a.s, b.s)
    assert not torch.equal(a.h, PF.CountSketch(10, 32, seed=1).h)
    assert a.h.dtype == torch.int64 and set(a.s.tolist()) <= {-1.0, 1.0}
    x = torch.randn(3, 10)
    want = torch.zeros(3, 32)
    for i in range(10):
        want[:, a.h[i]] += x[:, i] * a.s[i]
    torch.testing.assert_close(a(x), want)
