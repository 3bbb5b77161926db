"""The SVQA configuration of the benchmark (``perfbench/configs/svqa.json``)
on the CPU: the published values it states, and the port's plain path
against the benchmark's plain reference (``perfbench/reference/dualvgr.py``)
at a small width with the configuration's depth and graph: two stacked
DualVGR units, one graph layer, 20 clips.

The reference and the port share seeded random weights
(``perfbench/lib/weights.py``). Eval: the logits. Training, three steps
from one dropout seed with a clip that bites: each step's loss (its two
auxiliary terms each the mean over T = 2 unit cycles), the first clipped
gradient by module (Adam's first moment after step 1 over 1 - beta1), and
the parameters after step 3, at the tolerances of
``perfbench/tests/test_perfbench_reference.py``. The cell ``svqa.train``
through its driver at the benchmark's tiny CPU size (its two units kept):
a sound run is ``correct`` under the cell's limits; the bf16 control and
each planted fault are not.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dualvgr_tpu_torch import train_lib
from dualvgr_tpu_torch.models.dualvgr import build_model
from perfbench.drivers.train import module_norms
from perfbench.lib import common
from perfbench.lib.data import question_lengths
from perfbench.lib.weights import make_weights, parameters
from perfbench.reference import dualvgr as reference
from perfbench.tests.tiny import run_tiny

ROOT = Path(__file__).resolve().parent.parent
CONFIG = common.config("svqa")
DEPTH = {k: CONFIG["model"][k] for k in ("unit_layers", "graph_layers", "num_of_nodes")}
DIMS = dict(vision_dim=24, module_dim=16, word_dim=8, question_vocab_size=30, num_answers=11, **DEPTH)
B, FRAMES, T = 6, 4, 9
CLIP = 0.5  # below step 1's gradient norm at these widths, so that the clip scales it


def _inputs(seed):
    g = torch.Generator().manual_seed(seed)
    n, v = DIMS["num_of_nodes"], DIMS["vision_dim"]
    app, mot = torch.randn(B, n, FRAMES, v, generator=g), torch.randn(B, n, v, generator=g)
    qlen = torch.randint(2, T + 1, (B,), generator=g, dtype=torch.int32)
    q = torch.randint(1, DIMS["question_vocab_size"], (B, T), generator=g, dtype=torch.int32)
    q = (q * (torch.arange(T)[None, :] < qlen[:, None])).to(torch.int32)
    answers = torch.randint(0, DIMS["num_answers"], (B,), generator=g)
    return app, mot, q, qlen, answers, torch.tensor([1.0, 1, 1, 1, 1, 0])


def _port_and_weights(seed):
    weights = make_weights(reference.param_spec(**DIMS), seed, "cpu")
    model = build_model(device="cpu", use_kernels=False, **DIMS)
    model.load_state_dict(weights, strict=True)
    return model, weights


def test_the_config_states_the_published_values():
    with open(ROOT / "configs" / "svqa_DualVGR_20.yml") as f:
        yml = yaml.safe_load(f)
    m, tr = CONFIG["model"], CONFIG["train"]
    assert (m["graph_module"], m["graph_layers"]) == (yml["graph_module"], yml["graph_layers"])
    assert (m["num_of_nodes"], m["module_dim"], m["word_dim"]) == \
        (yml["train"]["num_of_nodes"], yml["train"]["module_dim"], yml["train"]["word_dim"]) == (20, 768, 300)
    assert (tr["batch_size"], tr["lr"], tr["num_workers"]) == \
        (yml["train"]["batch_size"], yml["train"]["lr"], yml["num_workers"])
    assert CONFIG["dataset_name"] == yml["dataset"]["name"] == "svqa"
    # the published train script builds every model with unit_layers 2
    assert m["unit_layers"] == 2 and "unit_layers" in CONFIG["published"]
    assert (m["frames_per_clip"], m["vision_dim"], m["compute_dtype"], m["tf32"]) == (16, 2048, "float32", False)
    videos = {s: len((ROOT / "SVQA_splits" / f"{s}_svqa_ids.txt").read_text().split()) for s in ("train", "val", "test")}
    assert (CONFIG["train_videos"], CONFIG["test_videos"]) == (videos["train"], videos["test"]) == (8400, 2400)
    # QA by split in proportion to videos: 118,680 over 12,000
    for s in ("train", "test"):
        assert CONFIG[f"{s}_questions"] == 118_680 * videos[s] // sum(videos.values())
    lengths = question_lengths(CONFIG["train_questions"], CONFIG["question_length"])
    assert lengths.max() == m["question_len"] == 40 and 19 <= lengths.mean() <= 21
    assert CONFIG["reduced"] == {} and set(CONFIG["assumed"]) >= {"questions_per_split", "question_length",
                                                                  "vocabulary", "first_token_share"}
    entry = next(c for c in common.manifest()["configs"] if c["name"] == "svqa")
    assert entry["source"] == CONFIG["source"] and entry["reduced"] == []


def test_eval_logits_match_the_reference():
    model, weights = _port_and_weights(21)
    app, mot, q, qlen, _, _ = _inputs(0)
    want = model(app, mot, q, qlen).logits
    with torch.no_grad():
        got = reference.forward(weights, app, mot, q, qlen, unit_layers=2, graph_layers=1)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_three_train_steps_match_the_reference():
    model, weights = _port_and_weights(22)
    state = train_lib.create_train_state(model, train_lib.make_optimizer(1e-3, 10, max_grad_norm=CLIP), seed=99)
    params = {k: v.clone() for k, v in parameters(weights).items()}
    buffers = {k: v.clone() for k, v in weights.items() if k not in params}
    adam = reference.Adam(params, 1e-3, CLIP)
    gen = torch.Generator().manual_seed(99)
    names = [k for k, _ in model.named_parameters()]
    for step in range(3):
        batch = _inputs(step)
        got = train_lib.train_step(state, batch, alpha=1.0, beta=1e-2)
        loss, clipped = reference.train_step(params, buffers, adam, batch, generator=gen, alpha=1.0, beta=1e-2,
                                             unit_layers=2, graph_layers=1)
        assert float(got["loss"]) == pytest.approx(loss, rel=1e-5), step
        if step == 0:
            assert adam.norms[0] > CLIP  # the clip scaled this step
            want = {k: float(g.norm()) for k, g in clipped.items()}
            first = {n: float((state.adam.state[p]["exp_avg"] / 0.1).norm()) for n, p in
                     zip(names, model.parameters())}
    # the stacked cycles' modules are all there, and each module's first
    # clipped gradient agrees
    by_module, by_module_ref = module_norms(first), module_norms(want)
    for bank in ("queryAttn", "queryPunish_motion", "acGCN", "motion_GCN", "attention_appearance"):
        assert {n.split(".")[2] for n in by_module if n.startswith(f"visual_input_unit.{bank}.")} == {"0", "1"}
    for name, v in by_module_ref.items():
        assert by_module[name] == pytest.approx(v, rel=1e-4), name
    # a leaf whose gradient is nought to rounding (a bias under a softmax)
    # moves under Adam by round-off alone
    median = float(np.median(list(want.values())))
    moving = {k for k, v in want.items() if v >= 1e-3 * median}
    assert len(moving) > len(want) - 12
    for name, p in model.named_parameters():
        if name in moving:
            torch.testing.assert_close(p.detach(), params[name], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("variant, fault", [(None, None), ("control", None), (None, "half"), (None, "unchanged")])
def test_the_cell_through_its_driver(variant, fault):
    out = run_tiny("svqa.train", variant=variant, faults=(fault,) if fault else (),
                   readings_only=bool(variant or fault))
    correct = all(c["ok"] for c in out["checks"]) and out["failed"] == 0
    assert correct == (variant is None and fault is None), out["checks"]
    assert out["attempted"] > 0 or variant or fault
