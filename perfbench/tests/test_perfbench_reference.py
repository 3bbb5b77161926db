"""The reference against the program's plain path at a tiny size on the
CPU: the same weights give the same logits, and the same train step from
the same dropout seed gives the same loss and gradients."""

import pytest
import torch

from dualvgr_tpu_torch import train_lib
from dualvgr_tpu_torch.models.dualvgr import build_model
from perfbench.lib.weights import make_weights, parameters
from perfbench.reference import dualvgr as reference

DIMS = dict(vision_dim=24, module_dim=16, word_dim=8, question_vocab_size=30, num_answers=11, num_of_nodes=5)


def inputs(b=6, t=7, seed=3):
    g = torch.Generator().manual_seed(seed)
    app = torch.randn(b, DIMS["num_of_nodes"], 4, DIMS["vision_dim"], generator=g)
    mot = torch.randn(b, DIMS["num_of_nodes"], DIMS["vision_dim"], generator=g)
    qlen = torch.randint(2, t + 1, (b,), generator=g, dtype=torch.int32)
    q = torch.randint(1, DIMS["question_vocab_size"], (b, t), generator=g, dtype=torch.int32)
    q = q * (torch.arange(t)[None, :] < qlen[:, None])
    return app, mot, q.to(torch.int32), qlen


@pytest.mark.parametrize("unit_layers,graph_layers", [(1, 1), (2, 1), (1, 2)])
def test_eval_logits(unit_layers, graph_layers):
    spec = reference.param_spec(**DIMS, unit_layers=unit_layers, graph_layers=graph_layers)
    weights = make_weights(spec, 11, "cpu")
    model = build_model(device="cpu", use_kernels=False, unit_layers=unit_layers, graph_layers=graph_layers, **DIMS)
    model.load_state_dict(weights, strict=True)
    app, mot, q, qlen = inputs()
    want = model(app, mot, q, qlen).logits
    with torch.no_grad():
        got = reference.forward(weights, app, mot, q, qlen, unit_layers=unit_layers, graph_layers=graph_layers)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_steps():
    spec = reference.param_spec(**DIMS)
    weights = make_weights(spec, 12, "cpu")
    model = build_model(device="cpu", use_kernels=False, unit_layers=1, **DIMS)
    model.load_state_dict(weights, strict=True)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 10), seed=99)
    params = {k: v.clone() for k, v in parameters(weights).items()}
    buffers = {k: v.clone() for k, v in weights.items() if k not in params}
    adam = reference.Adam(params, 1e-3)
    gen = torch.Generator().manual_seed(99)
    for step in range(2):
        app, mot, q, qlen = inputs(seed=step)
        answers = torch.randint(0, DIMS["num_answers"], (6,), generator=torch.Generator().manual_seed(step))
        valid = torch.tensor([1.0, 1, 1, 1, 1, 0])
        got = train_lib.train_step(state, (app, mot, q, qlen, answers, valid), alpha=1.0, beta=1e-2)
        loss, clipped = reference.train_step(params, buffers, adam, (app, mot, q, qlen, answers, valid), generator=gen,
                                       alpha=1.0, beta=1e-2)
        assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)
        if step == 0:
            norms = {k: float(g.norm()) for k, g in clipped.items()}
    # a leaf whose gradient is nought to rounding (a bias under a softmax)
    # moves under Adam by round-off alone
    median = sorted(norms.values())[len(norms) // 2]
    moving = {k for k, v in norms.items() if v >= 1e-3 * median}
    assert len(moving) > len(norms) - 8
    for name, p in model.named_parameters():
        if name not in moving:
            continue
        torch.testing.assert_close(p.detach(), params[name], rtol=1e-4, atol=1e-5)
