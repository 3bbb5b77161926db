"""The port's multi-device train step on real ranks, on the CPU.

Ranks are spawned by ``dualvgr_tpu_torch.parallel.dryrun.spawn``: a gloo
group joined through a ``file://`` store in a temporary directory (no TCP
port, so the suite's parallel workers cannot collide), each spawn with its
own timeout so that a hang fails instead of stalling the suite. Tiny
widths; every rank builds the model from the same seed.

* DP-2 and DP-4 against the port's one-process step on the same global
  batches, dropout on: each step's loss and the updated-parameter checksum
  within rtol 2e-6 (the JAX package's own bar,
  tests/test_multichip_scale.py:82-84); the second batch pads 3 of its 8
  rows, so the padding falls unevenly across the ranks (DP-4: 2, 2, 1 and 0
  valid rows), the case a per-rank mean gets wrong;
* DP-2 against the JAX package's ``data_mesh`` step on 2 of the 8 virtual
  CPU devices, from the same weights, dropout off: the loss (rtol 2e-4) and
  the parameters after two steps (atol 5e-5), as tests/test_torch_train.py
  holds the one-process step; except the biases of a softmax's logits
  (QueryAttn's ``fc.bias``, the GAT heads' ``a.bias``), whose gradient is
  the rounding residue of a sum that cancels (a softmax is invariant to a
  shift of its logits), so that Adam moves them by up to lr a step either
  way in any implementation: 2 * lr for them (measured: 6.6e-5 on
  ``queryAttn.0.fc.bias``; the one-process port is 4.2e-5 off JAX there);
* the gradient's all-reduce in 1 KB buckets launched during the backward
  against one bucket launched when it ends;
* TP (2, 2) + ZeRO-1 against DP-4 (the same limits as the DP cases), with
  sharded leaves counted; DP-2 + ZeRO-1 against the one-process step,
  whose update is ``torch.optim.Adam``'s;
* the batch norm's running statistics equal on every rank;
* every step of a placed state taken eagerly (no CUDA graph on a mesh);
* the eval step's predictions, gathered over the data axis, equal to one
  process's;
* the train CLI on two ranks with host-sharded loading, grad_accum 2 and
  ZeRO-1 against one process (the counterpart of tests/test_multihost.py's
  ``test_two_process_zero_grad_accum_hostsharded``), and a second epoch of
  each restored from its checkpoint (rank 0 reads it and broadcasts);
* the validate CLI on two ranks, each gathering its rows of every test
  batch, against one process on the same checkpoint;
* the dry-run CLI on two CPU ranks.
"""

import copy
import json
import os

import flax.linen
import jax
import numpy as np
import pytest
import torch

from dualvgr_tpu import train_lib as jtrain
from dualvgr_tpu.models import DualVGR as JaxDualVGR
from dualvgr_tpu.parallel import data_mesh, replicate, shard_batch
from dualvgr_tpu_torch.config import cfg_from_file, resolve_dataset_paths
from dualvgr_tpu_torch.parallel import dryrun
from dualvgr_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import dims
from test_torch_train import ALPHA, BETA, LR, jax_state, train_variables
from test_torch_train import batch as jbatch

TIMEOUT = 120.0
RTOL = 2e-6
# the second batch: 3 of 8 rows padded
BATCHES = dryrun.tiny_batches(1, seed=11) + dryrun.tiny_batches(1, seed=12, pad=3)
SPEC = dict(device="cpu", batches=BATCHES, eval=True, dropout=True, lr=1e-3)


@pytest.fixture(scope="module")
def jax_case():
    kw = dims(1, 1, 4)
    jmodel = JaxDualVGR(**kw)
    data = jbatch(4, seed=2)
    return kw, jmodel, data, train_variables(jmodel, data, seed=2)


@pytest.fixture(scope="module")
def one():
    return dryrun.run_steps(SPEC)


@pytest.fixture(scope="module")
def dp2(jax_case):
    """Two ranks: DP, DP + ZeRO-1, DP from the JAX weights with dropout
    off, and DP with the gradient all-reduced in 1 KB buckets during the
    backward."""
    kw, _, data, variables = jax_case
    jspec = dict(device="cpu", dims=kw, state_dict=from_jax_variables(variables), dropout=False, lr=LR,
                 alpha=ALPHA, beta=BETA, batches=[data, data], full_state=True)
    specs = [SPEC, dict(SPEC, tpu=dict(zero_opt=True)), jspec, dict(SPEC, bucket_mb=2**-10)]
    runs = dryrun.spawn(dryrun.steps_on_rank, 2, (specs,), device="cpu", timeout=TIMEOUT)
    return [[r[i] for r in runs] for i in range(len(specs))]


@pytest.fixture(scope="module")
def world4():
    """Four ranks: DP-4, then TP (2, 2) + ZeRO-1."""
    specs = [SPEC, dict(SPEC, tpu=dict(tensor_parallel=2, zero_opt=True))]
    runs = dryrun.spawn(dryrun.steps_on_rank, 4, (specs,), device="cpu", timeout=TIMEOUT)
    return [[r[i] for r in runs] for i in range(2)]


def _assert_matches(ranks, ref, rtol=RTOL):
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=rtol)
        np.testing.assert_allclose(r["checksum"], ref["checksum"], rtol=rtol)
        assert [m["correct"] for m in r["metrics"]] == [m["correct"] for m in ref["metrics"]]
        assert [m["count"] for m in r["metrics"]] == [m["count"] for m in ref["metrics"]]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_one_process(one, dp2, world4, world):
    ranks = dp2[0] if world == 2 else world4[0]
    assert len(ranks) == world and sorted(r["data_rank"] for r in ranks) == list(range(world))
    _assert_matches(ranks, one)
    # every rank ends with the same parameters
    assert len({r["checksum"] for r in ranks}) == 1


@pytest.mark.parametrize("world", [2, 4])
def test_uneven_padding_matches_one_process(one, dp2, world4, world):
    """The padded batch: its valid rows fall unevenly over the ranks, and
    the step is still the one-process step; a mean of per-rank means would
    weight the rows unequally."""
    ranks = dp2[0] if world == 2 else world4[0]
    valid = BATCHES[1][5].reshape(world, -1).sum(1)
    assert len(set(valid)) > 1
    assert one["metrics"][1]["count"] == 5
    for r in ranks:
        np.testing.assert_allclose(r["losses"][1], one["losses"][1], rtol=RTOL)


@pytest.mark.parametrize("world", [2, 4])
def test_every_step_of_a_placed_state_is_eager(one, dp2, world4, world):
    """No CUDA graph takes a step on a mesh (DP, ZeRO-1, TP), whatever the
    device; one process on the CPU is eager for its device."""
    runs = dp2 if world == 2 else world4
    assert all(r["eager"] == ["placed on a mesh"] * len(BATCHES) for ranks in runs for r in ranks)
    assert one["eager"] == ["on cpu"] * len(BATCHES)


def test_tp_zero_matches_dp4(world4):
    dp, tp = world4
    _assert_matches(tp, dp[0])
    assert all(r["tp_sharded_leaf_count"] > 0 for r in tp)
    assert all(r["tp_sharded_leaf_count"] == 0 for r in dp)
    # TP halves the parameters a rank holds, ZeRO its Adam state on top
    assert max(r["state_bytes"] for r in tp) < 0.6 * dp[0]["state_bytes"]


def test_gradient_buckets_launched_during_the_backward_match_one_bucket(dp2):
    """1 KB buckets, launched during the backward as their gradients are
    finished, against the default's one bucket at these widths (launched
    when the backward ends): on two ranks each sum is a + b whatever the
    bucket, so the steps are bit for bit the same."""
    default, small = dp2[0], dp2[3]
    assert [r["buckets"] for r in default] == [1, 1] and all(r["buckets"] > 20 for r in small)
    for r, d in zip(small, default):
        assert r["losses"] == d["losses"] and r["checksum"] == d["checksum"]


def test_zero_dp2_matches_one_process_adam(one, dp2):
    _assert_matches(dp2[1], one)
    assert all(r["state_bytes"] < dp2[0][0]["state_bytes"] for r in dp2[1])


def test_batchnorm_running_statistics_equal_on_every_rank(one, dp2, world4):
    for ranks in (dp2[0], dp2[1], world4[0], world4[1]):
        mean, var = ranks[0]["bn_running"]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r["bn_running"][0], mean)
            np.testing.assert_array_equal(r["bn_running"][1], var)
        np.testing.assert_allclose(mean, one["bn_running"][0], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var, one["bn_running"][1], rtol=1e-5, atol=1e-6)


def test_eval_step_predictions_are_gathered(one, dp2, world4):
    for ranks in (dp2[0], world4[0], world4[1]):
        for r in ranks:
            np.testing.assert_array_equal(r["preds"], one["preds"])


def test_dp2_matches_the_jax_data_mesh_step(jax_case, dp2, monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__", lambda self, x, *a, **k: x)
    _, jmodel, data, variables = jax_case
    jopt = jtrain.make_optimizer(LR, 10)
    mesh = data_mesh(devices=jax.devices()[:2])
    st = replicate(jax_state(jmodel, variables, jopt), mesh)
    step = jtrain.jit_train_step(jmodel, jopt, alpha=ALPHA, beta=BETA, donate=False)
    losses = []
    for _ in range(2):
        st, m = step(st, shard_batch(data, mesh))
        losses.append(float(m["loss"]))
    ranks = dp2[2]
    want = from_jax_variables({"params": jax.device_get(st.params), "batch_stats": jax.device_get(st.batch_stats)})
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=2e-4)
    got = ranks[0]["state_dict"]
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            atol = 2 * LR if k.endswith((".fc.bias", ".a.bias")) else 5e-5
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=atol, err_msg=k)


def _cli_cfg(synth_dir, out, **tpu):
    cfg = cfg_from_file(synth_dir["config"])
    cfg.dataset.save_dir = str(out)
    cfg.alpha, cfg.beta, cfg.unit_layers = 1.0, 1e-8, 1
    cfg.train.max_epochs = 1
    cfg.tpu.update(tpu)
    return resolve_dataset_paths(cfg)


CLI_TPU = dict(grad_accum=2, zero_opt=True, metrics_jsonl="m.jsonl")


@pytest.fixture(scope="module")
def cli_runs(synth_dir, tmp_path_factory):
    """One epoch of the train CLI in one process and on two ranks (each
    gathering its half of every batch, grad_accum 2, ZeRO-1); then a second
    epoch of each, restored from its checkpoint (on rank 0, broadcast)."""
    from dualvgr_tpu_torch import train as ttrain

    tmp = tmp_path_factory.mktemp("cli2")
    out = {}
    for epochs, restore in ((1, False), (2, True)):
        cfg1 = _cli_cfg(synth_dir, tmp / "one", **CLI_TPU)
        cfg2 = _cli_cfg(synth_dir, tmp / "two", **CLI_TPU)
        for c in (cfg1, cfg2):
            c.train.max_epochs, c.train.restore = epochs, restore
        best1, state1 = ttrain.train(cfg1, device="cpu")
        ranks = dryrun.spawn(dryrun.train_cli_on_rank, 2, (cfg2, "cpu"), device="cpu", timeout=TIMEOUT)
        out[epochs] = (cfg1, cfg2, best1, state1, ranks)
    return out


def _assert_cli_matches(cfg1, state1, ranks):
    """Adam at lr 1e-3 from two sum orders: an element whose gradient is
    near zero takes the sign of its step from the sum order, so a few
    elements move apart by up to 2 * lr an update; the rest stay within
    1e-5 (measured after one epoch: 15 of about 1e5 elements beyond 1e-5,
    the largest 1.4e-3; the same with and without ZeRO)."""
    got, want = ranks[0][1], state1.model.state_dict()
    params = [k for k in want if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    err = torch.cat([(got[k] - want[k]).abs().flatten() for k in params])
    assert (err > 1e-5).float().mean() < 1e-3, (err > 1e-5).sum()
    assert err.max() <= 2 * cfg1.train.lr * state1.updates, err.max()
    assert all(r[2] == state1.step for r in ranks)


def test_two_rank_cli_with_host_sharded_loading_and_grad_accum(cli_runs):
    """The train CLI on two ranks ends where one process ends; rank 0
    alone writes."""
    cfg1, cfg2, best1, state1, ranks = cli_runs[1]
    # the train and val loaders' (host_index, host_count)
    assert [r[3] for r in ranks] == [[(0, 2), (0, 2)], [(1, 2), (1, 2)]]
    assert all(r[0] == pytest.approx(best1) for r in ranks)
    _assert_cli_matches(cfg1, state1, ranks)
    # rank 0 alone wrote the metrics stream, with the one-process losses
    # (rtol 2e-5, tests/test_multihost.py's bar)
    records = [[json.loads(ln) for ln in open(os.path.join(c.dataset.save_dir, "log", "m.jsonl"))]
               for c in (cfg2, cfg1)]
    assert [r["type"] for r in records[0]] == [r["type"] for r in records[1]]
    for a, b in zip(*records):
        if a["type"] == "train":
            np.testing.assert_allclose(a["avg_loss"], b["avg_loss"], rtol=2e-5)
    saved = torch.load(os.path.join(cfg2.dataset.save_dir, "ckpt", "model", "state.pt"), weights_only=True)
    assert set(saved["state_dict"]) == set(state1.model.state_dict())


def test_two_rank_cli_restore_broadcasts_rank_0s_state(cli_runs):
    """A second epoch restored from each run's checkpoint (rank 0 reads it,
    the state with Adam's moments is broadcast and ZeRO-sliced) ends where
    the one-process restore ends."""
    cfg1, _, _, state1, ranks = cli_runs[2]
    assert state1.step == 2 * cli_runs[1][3].step
    _assert_cli_matches(cfg1, state1, ranks)


def test_two_rank_validate_cli_matches_one_process(cli_runs):
    """The validate CLI on two ranks, each gathering and evaluating its half
    of every test batch (15 questions in batches of 8: the last batch's
    valid rows fall 4 and 3), on the two-rank run's best checkpoint: the
    one-process CLI's accuracies, and rank 0 alone writes the same
    predictions file."""
    from dualvgr_tpu_torch import validate as tvalidate

    trained = cli_runs[2][1]
    cfg = copy.deepcopy(trained)  # validate.run puts save_dir under exp_name itself
    cfg.exp_name = os.path.basename(trained.dataset.save_dir)
    cfg.dataset.save_dir = os.path.dirname(trained.dataset.save_dir)
    cfg.test.write_preds = True
    want = tvalidate.run(cfg, 1, device="cpu")
    path = os.path.join(trained.dataset.save_dir, "preds", "test_preds.json")
    with open(path) as f:
        want_preds = json.load(f)
    os.remove(path)
    ranks = dryrun.spawn(dryrun.validate_cli_on_rank, 2, (cfg, 1, "cpu"), device="cpu", timeout=TIMEOUT)
    assert [r[1] for r in ranks] == [[(0, 2)], [(1, 2)]]
    assert ranks[0][0] == want and ranks[1][0][0] == want[0]
    with open(path) as f:
        assert json.load(f) == want_preds


def test_dryrun_cli_on_two_cpu_ranks(capsys):
    """``python -m dualvgr_tpu_torch.parallel.dryrun --nproc 2 --tp 2
    --device cpu``: DP and TP + ZeRO-1 against one process."""
    assert dryrun.main(["--nproc", "2", "--tp", "2", "--device", "cpu", "--timeout", str(TIMEOUT)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"] and report["dp"]["preds_equal"] and report["tp_zero"]["tp_sharded_leaf_count"] > 0
