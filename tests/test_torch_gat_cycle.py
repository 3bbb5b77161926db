"""The port's graph cycle against the JAX package's flax modules.

``gat_cycle_reference`` (and the ``gat_cycle`` wrapper, which takes it for
CPU tensors) against flax PunishGAT x 2 + AttentionSFGCN + the residual, as
tests/test_pallas.py holds the TPU kernel, including an odd batch size;
the port's PunishGAT / AttentionSFGCN modules against their flax
counterparts. fp32 on the CPU, atol 1e-5. The CUDA kernel is held against
its plain version on the card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dualvgr_tpu.models import graph as jgraph
from dualvgr_tpu_torch.models import graph as tgraph
from dualvgr_tpu_torch.ops import gat_kernel

ATOL = 1e-5


def _setup(rng, B, N, D, H):
    """Inputs and randomized flax params (non-zero biases, so every bias path
    is exercised)."""
    hd = D // H
    h = rng.randn(B, N, D).astype(np.float32)
    scores = rng.rand(B, N, hd).astype(np.float32)
    adj = jgraph.dense_self_loop_adjacency(N)
    jh, js = jnp.asarray(h), jnp.asarray(scores)

    def rand_like(tree):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray((rng.randn(*x.shape) * 0.2).astype(np.float32)), tree
        )

    gat = jgraph.PunishGAT(H, hd, in_dim=D)
    sf = jgraph.AttentionSFGCN(D, in_dim=D)
    vc = rand_like(gat.init(jax.random.PRNGKey(0), jh, adj, js, train=False))
    vs = rand_like(gat.init(jax.random.PRNGKey(1), jh, adj, js, train=False))
    vf = rand_like(sf.init(jax.random.PRNGKey(2), jnp.stack([jh, jh], 1)))
    return h, scores, adj, gat, sf, vc, vs, vf


def _jax_cycle(h, scores, adj, gat, sf, vc, vs, vf):
    jh, js = jnp.asarray(h), jnp.asarray(scores)
    common = gat.apply(vc, jh, adj, js, train=False)
    spec = gat.apply(vs, jh, adj, js, train=False)
    fused, _ = sf.apply(vf, jnp.stack([common, spec], 1))
    return np.asarray(jh + fused), np.asarray(common), np.asarray(spec)


def _kernel_args(D, H, vc, vs, vf):
    t = lambda x: torch.from_numpy(np.asarray(x, dtype=np.float32).copy())
    out = []
    for v in (vc, vs):
        p = v["params"]
        out += [t(np.asarray(p["w_kernel"]).reshape(D, D)), t(np.asarray(p["w_bias"]).reshape(D)),
                t(p["a"]), t(p["a_bias"])]
    pf = vf["params"]
    return out + [t(pf["proj_kernel"]), t(pf["proj_bias"]), t(pf["score_kernel"])]


@pytest.mark.parametrize("B,N,D,H", [(12, 5, 32, 4), (7, 4, 16, 4), (3, 16, 24, 2)])
@pytest.mark.parametrize("fn", ["gat_cycle_reference", "gat_cycle"])
def test_cycle_matches_flax_modules(rng, B, N, D, H, fn):
    h, scores, adj, gat, sf, vc, vs, vf = _setup(rng, B, N, D, H)
    want = _jax_cycle(h, scores, adj, gat, sf, vc, vs, vf)
    before = gat_kernel.gat_cycle.launches
    got = getattr(gat_kernel, fn)(
        torch.from_numpy(h), torch.from_numpy(scores), *_kernel_args(D, H, vc, vs, vf)
    )
    assert gat_kernel.gat_cycle.launches == before  # no kernel on CPU tensors
    for g, w, name in zip(got, want, ("out", "common", "spec")):
        assert g.shape == (B, N, D)
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)


def _load_gat(mod, v):
    """flax PunishGAT params -> the port's per-head Linears."""
    p = {k: np.array(x) for k, x in v["params"].items()}
    with torch.no_grad():
        for h in range(mod.n_heads):
            head = getattr(mod, f"attention_{h}")
            head.W.weight.copy_(torch.from_numpy(p["w_kernel"][:, h, :].T.copy()))
            head.W.bias.copy_(torch.from_numpy(p["w_bias"][h]))
            head.a.weight.copy_(torch.from_numpy(p["a"][h : h + 1]))
            head.a.bias.copy_(torch.from_numpy(p["a_bias"][h : h + 1]))


def test_graph_modules_match_flax(rng):
    B, N, D, H = 6, 5, 32, 4
    h, scores, adj, gat, sf, vc, vs, vf = _setup(rng, B, N, D, H)
    want_out, want_common, want_spec = _jax_cycle(h, scores, adj, gat, sf, vc, vs, vf)

    tc, ts = tgraph.PunishGAT(H, D // H, in_dim=D), tgraph.PunishGAT(H, D // H, in_dim=D)
    _load_gat(tc, vc)
    _load_gat(ts, vs)
    tsf = tgraph.AttentionSFGCN(D, D)
    pf = vf["params"]
    with torch.no_grad():
        tsf.project[0].weight.copy_(torch.from_numpy(np.asarray(pf["proj_kernel"]).T.copy()))
        tsf.project[0].bias.copy_(torch.from_numpy(np.array(pf["proj_bias"])))
        tsf.project[2].weight.copy_(torch.from_numpy(np.asarray(pf["score_kernel"]).T.copy()))
        tadj = tgraph.dense_self_loop_adjacency(N)
        np.testing.assert_allclose(tadj.numpy(), np.asarray(adj), atol=1e-7)
        th, tsc = torch.from_numpy(h), torch.from_numpy(scores)
        common, spec = tc(th, tadj, tsc), ts(th, tadj, tsc)
        fused, beta = tsf(torch.stack([common, spec], 1))
    assert beta.shape == (B, 2, N, 1)
    np.testing.assert_allclose(common.numpy(), want_common, atol=ATOL)
    np.testing.assert_allclose(spec.numpy(), want_spec, atol=ATOL)
    np.testing.assert_allclose((th + fused).numpy(), want_out, atol=ATOL)



@pytest.mark.slow
def test_cycle_reference_matches_pallas_interpret(rng):
    """The port's plain cycle against the TPU kernel itself, run in Pallas
    interpret mode on the CPU, with a batch the TPU kernel pads."""
    from dualvgr_tpu.ops.gat_pallas import fused_gat_cycle

    B, N, D, H = 6, 4, 16, 4
    h, scores, _, _, _, vc, vs, vf = _setup(rng, B, N, D, H)
    args = _kernel_args(D, H, vc, vs, vf)
    want = fused_gat_cycle(
        jnp.asarray(h), jnp.asarray(scores), *(jnp.asarray(a.numpy()) for a in args),
        block_b=4, interpret=True,
    )
    got = gat_kernel.gat_cycle_reference(torch.from_numpy(h), torch.from_numpy(scores), *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
