"""The port's checkpoints: bit-exact round trips, resumed steps, and the
reference ``.pt`` schema shared with the JAX package.

* save -> restore reproduces every field bit for bit: the parameters and
  buffers, Adam's moments and step, the counts, a partly filled gradient
  accumulation window and the dropout generator's state;
* a train step from the restored state equals the step the saved state
  takes, bit for bit on the CPU, dropout on;
* ``state.pt`` is a reference ``*_model.pt``: the JAX package's
  ``port_reference.convert_reference_checkpoint`` reads it unchanged, and
  the JAX ``validate.main`` on the converted checkpoint prints the port's
  accuracies;
* ``load_reference_checkpoint`` reads a ``.pt`` written by the JAX
  package's ``convert_to_reference`` (and strips a ``module.`` prefix).
"""

import os

import jax
import numpy as np
import pytest
import torch

from dualvgr_tpu import train_lib as jtrain
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.utils import port_reference
from dualvgr_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from dualvgr_tpu_torch import build_model, create_train_state, make_optimizer, train_step
from dualvgr_tpu_torch.config import cfg_from_file, resolve_dataset_paths
from dualvgr_tpu_torch.train import model_kwargs_tosave
from dualvgr_tpu_torch.utils.checkpoint import (
    load_model_kwargs, load_reference_checkpoint, restore_checkpoint, save_checkpoint, saved_epoch,
)
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import random_variables

DIMS = dict(vision_dim=12, module_dim=16, word_dim=8, question_vocab_size=20, num_answers=7, num_of_nodes=3,
            graph_layers=1, unit_layers=1)
KWARGS = {k: DIMS[k] for k in ("vision_dim", "module_dim", "word_dim", "num_of_nodes", "graph_layers",
                               "unit_layers")} | {"graph_module": "GAT"}


def batch(seed, b=5, t=6):
    rng = np.random.RandomState(seed)
    qlen = rng.randint(1, t + 1, (b,)).astype(np.int32)
    q = rng.randint(1, DIMS["question_vocab_size"], (b, t)).astype(np.int32)
    for i in range(b):
        q[i, qlen[i]:] = 0
    valid = np.ones(b, np.float32)
    valid[-1] = 0.0
    return (rng.randn(b, 3, 2, 12).astype(np.float32), rng.randn(b, 3, 12).astype(np.float32), q, qlen,
            rng.randint(0, DIMS["num_answers"], (b,)).astype(np.int32), valid)


def trained_state(grad_accum, steps, seed=0):
    model = build_model(device="cpu", seed=seed, **DIMS)
    state = create_train_state(model, make_optimizer(1e-3, 4, grad_accum=grad_accum), seed=seed)
    for i in range(steps):
        train_step(state, batch(i), alpha=1.0, beta=1e-8)
    return state


def fresh_state(grad_accum):
    return trained_state(grad_accum, 0, seed=9)


def assert_states_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.adam.state_dict(), b.adam.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert (a.step, a.updates, a.mini_step) == (b.step, b.updates, b.mini_step)
    assert len(a.acc_grads) == len(b.acc_grads)
    assert all(torch.equal(x, y) for x, y in zip(a.acc_grads, b.acc_grads))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_save_restore_is_bit_exact(tmp_path, grad_accum):
    state = trained_state(grad_accum, steps=3)  # with grad_accum 2, one micro-gradient waits
    assert state.mini_step == (1 if grad_accum == 2 else 0) and state.updates == (1 if grad_accum == 2 else 3)
    assert saved_epoch(str(tmp_path)) is None
    save_checkpoint(str(tmp_path), 4, state, KWARGS)
    assert saved_epoch(str(tmp_path)) == 4 and load_model_kwargs(str(tmp_path)) == KWARGS
    saved = torch.load(tmp_path / "model" / "state.pt", weights_only=True)
    assert {"epoch", "state_dict", "optimizer", "model_kwargs"} <= saved.keys()  # the reference's schema
    assert {"step", "updates", "mini_step", "acc_grads", "generator"} <= saved.keys()
    restored = fresh_state(grad_accum)
    epoch, restored = restore_checkpoint(str(tmp_path), restored)
    assert epoch == 4
    assert_states_equal(restored, state)
    with pytest.raises(ValueError, match="grad_accum"):
        restore_checkpoint(str(tmp_path), fresh_state(3 - grad_accum))
    os.remove(tmp_path / "model" / "meta.json")
    assert saved_epoch(str(tmp_path)) == -1


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_step_from_the_restored_state_equals_the_uninterrupted_step(tmp_path, grad_accum):
    state = trained_state(grad_accum, steps=3)
    save_checkpoint(str(tmp_path), 0, state, KWARGS)
    _, restored = restore_checkpoint(str(tmp_path), fresh_state(grad_accum))
    for i in (7, 8):  # with grad_accum 2 the first closes the waiting window
        want = train_step(state, batch(i), alpha=1.0, beta=1e-8)
        got = train_step(restored, batch(i), alpha=1.0, beta=1e-8)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert_states_equal(restored, state)


def _synth_cfg(synth_dir, save_dir):
    text = open(synth_dir["config"]).read()
    lines = [f"  save_dir: '{save_dir}/'" if ln.strip().startswith("save_dir") else ln for ln in text.splitlines()]
    path = os.path.join(save_dir, "svqa.yml")
    os.makedirs(save_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _accuracy_lines(text):
    return [ln for ln in text.splitlines() if "Accuracy:" in ln]


def test_the_jax_package_reads_the_port_checkpoint(synth_dir, tmp_path, capsys):
    """train a little on the synth fixture, save; the JAX converter reads
    state.pt as a reference checkpoint and JAX validate.main prints the
    port's accuracies."""
    from dualvgr_tpu_torch import train as ttrain
    from dualvgr_tpu_torch import validate as tvalidate

    import validate as jax_validate  # the JAX package's root CLI

    port_cfg = _synth_cfg(synth_dir, str(tmp_path / "port"))
    cfg = cfg_from_file(port_cfg)
    cfg.unit_layers = 1
    rcfg = resolve_dataset_paths(cfg)
    loader = ttrain.make_loader(rcfg, rcfg.dataset.train_question_pt, shuffle=True, device="cpu")
    model = ttrain.build_model(rcfg, loader.vocab, "cpu")
    state = create_train_state(model, make_optimizer(rcfg.train.lr, len(loader)), seed=rcfg.seed)
    for b in loader:
        train_step(state, (b.appearance_feat, b.motion_feat, b.question, b.question_len, b.answer, b.valid),
                   alpha=1.0, beta=1e-8)
    ckpt = tmp_path / "port" / cfg.exp_name / "ckpt"
    save_checkpoint(str(ckpt), 0, state, model_kwargs_tosave(cfg))
    capsys.readouterr()
    port_acc = tvalidate.main(["--cfg", port_cfg, "--unit_layers", "1", "--device", "cpu"])
    port_lines = _accuracy_lines(capsys.readouterr().out)

    jax_cfg = _synth_cfg(synth_dir, str(tmp_path / "jax"))
    kw = port_reference.convert_reference_checkpoint(
        str(ckpt / "model" / "state.pt"), str(tmp_path / "jax" / cfg.exp_name / "ckpt"))
    assert kw == model_kwargs_tosave(cfg)
    jax_acc = jax_validate.main(["--cfg", jax_cfg, "--unit_layers", "1"])
    jax_lines = _accuracy_lines(capsys.readouterr().out)
    assert len(port_lines) == 16 and port_lines == jax_lines
    assert port_acc == pytest.approx(float(jax_acc), abs=0)


def test_load_reference_checkpoint_reads_the_jax_export(tmp_path):
    jmodel = JaxDualVGR(**DIMS)
    example = tuple(np.asarray(x[:1]) for x in batch(0)[:4])
    variables = random_variables(jmodel, example, seed=2)
    jstate = jtrain.create_train_state(jmodel, jax.random.PRNGKey(0), example, jtrain.make_optimizer(1e-3, 4))
    jstate = jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    jax_save_checkpoint(str(tmp_path / "jax"), 5, jstate, KWARGS)
    pt = str(tmp_path / "ref_model.pt")
    port_reference.convert_to_reference(str(tmp_path / "jax"), pt)

    sd, kwargs = load_reference_checkpoint(pt)
    assert kwargs == {k: v for k, v in KWARGS.items() if k != "unit_layers"}
    want = from_jax_variables(variables)
    model = build_model(device="cpu", **DIMS)
    model.load_state_dict(sd, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, torch.as_tensor(want[k])), k
    # a DataParallel-saved reference checkpoint carries a module. prefix
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}, "model_kwargs": kwargs},
               tmp_path / "dp_model.pt")
    sd2, _ = load_reference_checkpoint(str(tmp_path / "dp_model.pt"))
    assert sd2.keys() == sd.keys() and all(torch.equal(sd2[k], sd[k]) for k in sd)
