"""The port's AOT export (``dualvgr_tpu_torch/export.py``) against the JAX package's.

The same randomized weights (every leaf from numpy) go into the JAX
package's flax DualVGR and, through ``from_jax_variables``, into the port;
each package exports its serving program for the CPU, saves and loads it.
Tolerances (fp32 on the CPU): the port's artifact against the port's live
predict fn: top-k ids equal, scores within 1e-6 (the same graph, traced);
against the JAX package's artifact: scores within 1e-5 and top ids equal
except where the JAX top two scores lie within 1e-5 (another sum order,
as ``tests/test_torch_serving.py``). Under ``compute_dtype: bfloat16`` the
port's artifact is held to the bf16 limits of PERF.md §2 against the JAX
fp32 program: with delta = 5e-2 x max|logit|, each score within a factor
exp(+-2 delta) of the fp32 probability of its id, and a top-1 id differing
only where the fp32 top-2 logit margin is within 2 delta. The port's
graph must hold the kernels' custom ops (three ``bilstm_recurrence``, two
``gat_cycle``, and one ``input_proj_f32`` in fp32 or ``input_proj_both``
under bf16) and no plain
version of them: no LeakyReLU (the graph cycle's attention) and no
``chunk`` (the LSTM cell), so the plain path is not baked in. A GCN model's
artifact (``graph_module: GCN``) holds the three ``bilstm_recurrence``
nodes, the ``input_proj_f32`` and no ``gat_cycle``, and matches the JAX package's GCN artifact.
"""

import numpy as np
import pytest
import torch

from dualvgr_tpu import export as jax_export
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu_torch import build_model, build_predict_fn
from dualvgr_tpu_torch import export as texport
from dualvgr_tpu_torch.serving import ServingProgram
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import random_variables

KW = dict(
    vision_dim=24, module_dim=16, word_dim=8, question_vocab_size=30,
    num_answers=10, num_of_nodes=4, graph_layers=1, unit_layers=1,
)
B, C, F, T, K = 4, 4, 3, 5, 3
TOL_BF16_LOGITS = 5e-2
KERNEL_OPS = {"float32": {"bilstm_recurrence": 3, "gat_cycle": 2, "input_proj_f32": 1},
              "bfloat16": {"bilstm_recurrence": 3, "gat_cycle": 2, "input_proj_both": 1},
              "GCN": {"bilstm_recurrence": 3, "input_proj_f32": 1}}
PLAIN_SIGNATURES = ("aten.leaky_relu.default", "aten.chunk.default")


def batch(seed=3):
    rng = np.random.RandomState(seed)
    app = rng.randn(B, C, F, KW["vision_dim"]).astype(np.float32)
    mot = rng.randn(B, C, KW["vision_dim"]).astype(np.float32)
    qlen = np.array([1, T, 3, 2], np.int32)
    q = rng.randint(1, KW["question_vocab_size"], (B, T)).astype(np.int32)
    for i in range(B):
        q[i, qlen[i]:] = 0
    return app, mot, q, qlen


def jax_side(tmp_path, graph_module="GAT"):
    """(flax model, variables, the JAX artifact's predict fn)."""
    model = JaxDualVGR(**KW, graph_module=graph_module)
    variables = random_variables(model, batch())
    payload, meta = jax_export.export_serving(
        model, variables, max_batch=B, app_shape=(C, F, KW["vision_dim"]), mot_shape=(C, KW["vision_dim"]),
        max_q_len=T, top_k=K, platforms=("cpu",),
    )
    path = str(tmp_path / "jax.dvgr")
    jax_export.save_artifact(path, payload, meta)
    return model, variables, jax_export.load_artifact(path)[0], path


def port_artifact(tmp_path, variables, compute_dtype="float32", graph_module="GAT"):
    """(port model, artifact path, meta) for the CPU, kernel routing on."""
    model = build_model(device="cpu", compute_dtype=compute_dtype, graph_module=graph_module, **KW)
    model.load_state_dict(from_jax_variables(variables))
    payload, meta = texport.export_serving(
        model, max_batch=B, app_shape=(C, F, KW["vision_dim"]), mot_shape=(C, KW["vision_dim"]), max_q_len=T,
        top_k=K, platforms=("cpu",),
    )
    path = str(tmp_path / f"port_{graph_module}_{compute_dtype}.dvgr")
    texport.save_artifact(path, payload, meta)
    return model, path, meta


def check_graph(path, kind):
    """``kind``: a compute dtype of the GAT model, or "GCN"."""
    ops = texport.graph_ops(texport.load_artifact(path, "cpu")[0].program)
    want = {f"dualvgr_torch.{k}.default": n for k, n in KERNEL_OPS[kind].items()}
    assert {k: ops[k] for k in want} == want, ops
    assert sum(n for k, n in ops.items() if k.startswith("dualvgr_torch.")) == sum(want.values()), ops
    assert not any(ops[s] for s in PLAIN_SIGNATURES), {s: ops[s] for s in PLAIN_SIGNATURES}


def test_fp32_artifact_matches_live_and_jax_artifact(tmp_path):
    fp32_artifact_case(tmp_path, "GAT")


def test_gcn_artifact_matches_live_and_jax_artifact(tmp_path):
    fp32_artifact_case(tmp_path, "GCN")


def fp32_artifact_case(tmp_path, graph_module):
    _, variables, jax_predict, _ = jax_side(tmp_path, graph_module)
    model, path, meta = port_artifact(tmp_path, variables, graph_module=graph_module)
    assert meta["platforms"] == ["cpu"] and meta["max_batch"] == B and meta["top_k"] == K
    assert meta["app_shape"] == [C, F, KW["vision_dim"]] and meta["mot_shape"] == [C, KW["vision_dim"]]
    check_graph(path, "float32" if graph_module == "GAT" else graph_module)

    predict, loaded_meta = texport.load_artifact(path, device="cpu")
    assert loaded_meta == meta
    inputs = batch()
    got_i, got_p = predict(*inputs)
    live_i, live_p = build_predict_fn(model, K, device="cpu")(*inputs)
    np.testing.assert_array_equal(got_i, live_i)
    np.testing.assert_allclose(got_p, live_p, rtol=0, atol=1e-6)

    want_i, want_p = (np.asarray(a) for a in jax_predict(*inputs))
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    tie = want_p[:, 0] - want_p[:, 1] <= 1e-5
    assert ((got_i[:, 0] == want_i[:, 0]) | tie).all()
    assert (np.diff(got_p, axis=1) <= 1e-7).all() and (got_p > 0).all() and (got_p <= 1).all()


def test_bf16_artifact_holds_kernel_6_and_the_bf16_limits(tmp_path):
    jmodel, variables, jax_predict, _ = jax_side(tmp_path)
    model, path, _ = port_artifact(tmp_path, variables, "bfloat16")
    check_graph(path, "bfloat16")
    predict, _ = texport.load_artifact(path, device="cpu")
    inputs = batch()
    got_i, got_p = predict(*inputs)
    live_i, live_p = build_predict_fn(model, K, device="cpu")(*inputs)
    np.testing.assert_array_equal(got_i, live_i)
    np.testing.assert_allclose(got_p, live_p, rtol=0, atol=1e-6)

    logits = np.asarray(jmodel.apply(variables, *inputs, train=False).logits, np.float64)
    delta = TOL_BF16_LOGITS * np.abs(logits).max()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.take_along_axis(probs, got_i, axis=1)
    assert (np.abs(got_p - want) <= want * np.expm1(2 * delta) + 1e-6).all()
    top2 = np.sort(logits, axis=-1)[:, -2:]
    want_i = np.asarray(jax_predict(*inputs)[0])
    assert ((got_i[:, 0] == want_i[:, 0]) | (top2[:, 1] - top2[:, 0] <= 2 * delta)).all()


def test_each_loader_refuses_the_other_packages_file_and_junk(tmp_path):
    _, variables, _, jax_path = jax_side(tmp_path)
    _, port_path, _ = port_artifact(tmp_path, variables)
    junk = tmp_path / "junk.dvgr"
    junk.write_bytes(b"definitely not an export artifact")
    for path in (jax_path, str(junk)):
        with pytest.raises(ValueError, match="not a dualvgr export artifact"):
            texport.load_artifact(path, device="cpu")
    for path in (port_path, str(junk)):
        with pytest.raises(ValueError, match="not a dualvgr export artifact"):
            jax_export.load_artifact(path)


def test_loading_for_a_platform_the_artifact_lacks_raises(tmp_path):
    _, variables, _, _ = jax_side(tmp_path)
    _, path, meta = port_artifact(tmp_path, variables)
    meta_cuda, payload = texport.read_artifact(path)
    meta_cuda["platforms"] = ["cuda"]  # the same bytes, declared for the card only
    cuda_only = str(tmp_path / "cuda_only.dvgr")
    texport.save_artifact(cuda_only, payload, meta_cuda)
    with pytest.raises(ValueError, match="exported for \\['cuda'\\]"):
        texport.load_artifact(cuda_only, device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        texport.export_serving(build_model(device="cpu", **KW), max_batch=B, app_shape=(C, F, 24),
                               mot_shape=(C, 24), max_q_len=T, top_k=K, platforms=("tpu",))


def test_exported_program_keeps_the_stride_0_scores():
    """The graph cycle's per-clip scores reach the op as a stride-0
    broadcast: the traced node's input is an expand of the scores, as in
    the eager call, not a copy."""
    model = build_model(device="cpu", **KW)
    args = tuple(torch.as_tensor(a) for a in batch())
    with torch.no_grad():
        program = torch.export.export(ServingProgram(model, K).eval(), args)
    for node in program.graph.nodes:
        if node.target is torch.ops.dualvgr_torch.gat_cycle.default:
            scores = node.args[1].meta["val"]
            assert scores.stride()[-1] == 0, scores.stride()
            break
    else:
        raise AssertionError("no gat_cycle node")


def _opcheck_cases():
    rs = np.random.RandomState(0)
    t = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    lens = torch.tensor([1, 2, 3, 4, 5, 5, 2], dtype=torch.int32)
    b, n, d, heads = 3, 4, 16, 4
    hd = d // heads
    return {
        "recurrence_outputs": ("bilstm_recurrence", (t(5, 7, 32), t(5, 7, 32), t(8, 32), t(8, 32), lens, True)),
        "recurrence_bf16_final": ("bilstm_recurrence", (t(5, 7, 32).bfloat16(), t(5, 7, 32).bfloat16(), t(8, 32),
                                                        t(8, 32), None, False)),
        "gat_cycle_stride0_scores": ("gat_cycle", (t(b, n, d), t(b, n, 1).expand(b, n, hd), t(d, d), t(d),
                                                   t(heads, 2 * hd), t(heads), t(d, d), t(d), t(heads, 2 * hd),
                                                   t(heads), t(d, d), t(d), t(d, 1))),
        "proj_both_tanh": ("input_proj_both", (t(3, 5, 16), t(32, 16), t(32), t(32, 16), t(32), True)),
        "proj_both_bf16_x": ("input_proj_both", (t(3, 5, 16).bfloat16(), t(32, 16), t(32), t(32, 16), t(32),
                                                 False)),
        "proj_f32": ("input_proj_f32", (t(3, 5, 16), t(32, 16), t(32), t(32, 16), t(32))),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_custom_ops_pass_opcheck(case):
    """``torch.library.opcheck`` on CPU tensors: the schema, the fake
    (meta) implementation's shapes, strides and dtypes against the real
    one's, and the autograd registration (none: the wrappers refuse grad);
    the op's result is its plain version's, bit for bit."""
    name, args = _opcheck_cases()[case]
    op = getattr(torch.ops.dualvgr_torch, name)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    ref = {"bilstm_recurrence": lambda *a: texport.lstm_kernel.bilstm_recurrence_reference(
               *a[:5], with_outputs=a[5]),
           "gat_cycle": texport.gat_kernel.gat_cycle_reference,
           "input_proj_both": lambda *a: texport.proj_kernel.input_proj_both_reference(*a[:5], fuse_tanh=a[5]),
           "input_proj_f32": texport.proj_kernel.input_proj_f32_reference}
    want = ref[name](*args)
    got = op(*args)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
