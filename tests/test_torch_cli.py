"""The port's train and validate CLIs, end to end on the CPU.

On the conftest ``synth_dir`` SVQA fixture, with ``--device cpu``:

* ``dualvgr_tpu_torch.train.main`` then ``.validate.main`` leave the JAX
  CLIs' file layout (best checkpoint, logs, predictions) and print
  "Test Accuracy"; ``tpu.profile_dir`` gets a trace of the second epoch
  and its validation, which holds the program's spans as ranges, the
  loader's producer thread's too, with the epoch's loader counters logged
  beside its path;
* preemption, as tests/test_train.py checks it for the JAX train.py: a
  pre-set ``stop_event`` autosaves epoch -1 and stops; the restore run
  finishes, deletes the autosave and leaves a best checkpoint;
* ``tpu.metrics_jsonl`` records carry the JAX train.py's keys, at every
  ``tpu.log_every`` steps and at each epoch's end;
* with ``tpu.grad_accum: 2`` the logged lr is the JAX train.py's formula
  across the decay at epoch 10;
* the data keys reach the loaders; an unknown ``graph_module``, a data
  axis named "model", ``tensor_parallel`` in one process and a JAX
  ``prng_impl`` are refused, ``zero_opt`` in one process is accepted;
* a config without ``graph_module`` trains and validates the default GCN
  model, records "GCN" in ``model_kwargs.json``, and the export and the
  HTTP front's checkpoint loader build the GCN from it;
* ``main()`` without ``--device`` raises on a machine without CUDA.
"""

import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from dualvgr_tpu.train_lib import make_lr_schedule as jax_lr_schedule
from dualvgr_tpu_torch import export as texport
from dualvgr_tpu_torch import train as ttrain
from dualvgr_tpu_torch import validate as tvalidate
from dualvgr_tpu_torch.config import cfg_from_file, resolve_dataset_paths
from dualvgr_tpu_torch.utils import trace
from dualvgr_tpu_torch.utils.checkpoint import saved_epoch

# the JAX train.py's record fields (its train.py:281-305 and :324-331)
TRAIN_KEYS = {"type", "wall_s", "epoch", "step", "ce", "avg_loss", "batch_acc", "avg_acc", "lr"}
VAL_KEYS = {"type", "wall_s", "epoch", "acc", "categories", "best"}


def write_cfg(synth_dir, out, max_epochs=2, **tpu):
    """The synth config with save_dir under ``out``, ``max_epochs`` and
    ``tpu`` keys set."""
    text = open(synth_dir["config"]).read()
    lines = [f"  save_dir: '{out}/results/'" if ln.strip().startswith("save_dir")
             else f"  max_epochs: {max_epochs}" if ln.strip().startswith("max_epochs") else ln
             for ln in text.splitlines()]
    if tpu:
        lines += ["tpu:"] + [f"  {k}: {json.dumps(v)}" for k, v in tpu.items()]
    path = os.path.join(out, "svqa_cli.yml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def cli_cfg(synth_dir, tmp_path, max_epochs=2, **tpu):
    """What train.main makes of the config, for calling train() directly."""
    cfg = cfg_from_file(write_cfg(synth_dir, str(tmp_path), **tpu))
    cfg.dataset.save_dir = str(tmp_path / "run")
    cfg.alpha, cfg.beta, cfg.unit_layers = 1.0, 1e-8, 1
    cfg.train.max_epochs = max_epochs
    return resolve_dataset_paths(cfg)


def test_train_then_validate_cli(synth_dir, tmp_path, capsys):
    cfg = write_cfg(synth_dir, str(tmp_path), profile_dir=str(tmp_path / "prof"))
    best_val, state = ttrain.main(["--cfg", cfg, "--alpha", "1", "--beta", "1e-8", "--unit_layers", "1",
                                   "--device", "cpu"])
    run = tmp_path / "results" / "expSynth-svqa"
    ckpt = run / "ckpt" / "model"
    for name in ("model_kwargs.json", "meta.json", "state.pt"):
        assert (ckpt / name).exists(), name
    assert not (run / "ckpt_autosave").exists()  # a clean finish deletes the autosave
    assert json.load(open(ckpt / "model_kwargs.json"))["graph_module"] == "GAT"
    assert any(f.endswith("_stdout.log") for f in os.listdir(run / "log"))
    assert os.listdir(tmp_path / "prof") == ["trace_epoch1.json"]
    assert 0.0 < best_val <= 1.0 and state.step == 12 and state.model.training

    acc = tvalidate.main(["--cfg", cfg, "--unit_layers", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Test Accuracy" in out and "Display 10 samples" in out
    preds = json.load(open(run / "preds" / "test_preds.json"))
    assert len(preds) == 15 and set(preds[0]) == {"video_id", "question_id", "video_name", "question", "answer",
                                                  "prediction"}
    assert acc == pytest.approx(np.mean([p["answer"] == p["prediction"] for p in preds]))


def test_the_profiled_epoch_carries_the_programs_spans(synth_dir, tmp_path, caplog):
    cfg = cli_cfg(synth_dir, tmp_path, profile_dir=str(tmp_path / "prof"))
    with caplog.at_level(logging.INFO):
        ttrain.train(cfg, device="cpu")
    events = json.load(open(tmp_path / "prof" / "trace_epoch1.json"))["traceEvents"]
    ranges = {e["name"] for e in events if e.get("ph") == "X"}
    assert {"train.forward", "train.backward", "train.optimizer", "optimizer.clip", "optimizer.adam",
            "loader.get", "loader.gather", "loader.put", "validate.fetch", "validate.tally"} <= ranges
    main = {e["tid"] for e in events if e.get("name") == "train.forward"}
    producer = {e["tid"] for e in events if e.get("name") in ("loader.gather", "loader.put")}
    assert len(main) == 1 and producer and not producer & main  # the producer's own thread
    names = [e["name"] for e in events if e.get("ph") == "X"]
    assert names.count("validate.fetch") == 2 and names.count("validate.tally") == 1  # one pass, 2 batches
    assert not trace.is_on()  # off after the epoch
    logged = [r.getMessage() for r in caplog.records if "wrote profiler trace" in r.getMessage()]
    # 6 training batches and 2 validation batches, of 8
    assert len(logged) == 1 and "'loader.batches': 8," in logged[0] and "'loader.rows': 64," in logged[0]


def test_a_config_without_graph_module_trains_the_default_gcn(synth_dir, tmp_path, capsys):
    path = write_cfg(synth_dir, str(tmp_path), max_epochs=1)
    lines = open(path).read().splitlines()
    kept = [ln for ln in lines if not ln.startswith("graph_module")]
    assert len(kept) == len(lines) - 1
    with open(path, "w") as f:
        f.write("\n".join(kept) + "\n")
    _, state = ttrain.main(["--cfg", path, "--alpha", "1", "--beta", "1e-8", "--unit_layers", "1",
                            "--device", "cpu"])
    assert type(state.model.visual_input_unit.acGCN[0]).__name__ == "PunishGCN"
    ckpt = tmp_path / "results" / "expSynth-svqa" / "ckpt" / "model"
    assert json.load(open(ckpt / "model_kwargs.json"))["graph_module"] == "GCN"
    assert "visual_input_unit.acGCN.0.gc1.weight" in torch.load(ckpt / "state.pt")["state_dict"]
    acc = tvalidate.main(["--cfg", path, "--unit_layers", "1", "--device", "cpu"])
    assert "Test Accuracy" in capsys.readouterr().out and 0.0 <= acc <= 1.0
    # the deployment path builds the saved module: the HTTP front's loader and the export
    cfg = cfg_from_file(path)
    cfg.dataset.save_dir = os.path.join(cfg.dataset.save_dir, cfg.exp_name)
    model, _ = texport.model_from_checkpoint(cfg, 1, device="cpu")
    assert type(model.visual_input_unit.acGCN[0]).__name__ == "PunishGCN"
    meta = texport.main(["--cfg", path, "--out", str(tmp_path / "gcn.dvgr"), "--max-batch", "4",
                         "--platforms", "cpu"])
    ops = texport.graph_ops(texport.load_artifact(str(tmp_path / "gcn.dvgr"), "cpu")[0].program)
    assert meta["platforms"] == ["cpu"] and ops["dualvgr_torch.bilstm_recurrence.default"] == 3
    assert ops["dualvgr_torch.gat_cycle.default"] == 0


def test_preemption_autosave_and_resume(synth_dir, tmp_path):
    cfg = cli_cfg(synth_dir, tmp_path)
    ckpt_dir = os.path.join(cfg.dataset.save_dir, "ckpt")
    autosave_dir = ckpt_dir + "_autosave"
    stop = threading.Event()
    stop.set()  # checkpoint at the first step of epoch 0 (saved epoch -1) and return
    ttrain.train(cfg, stop_event=stop, device="cpu")
    assert saved_epoch(autosave_dir) == -1
    assert saved_epoch(ckpt_dir) is None  # never reached validation
    cfg.train.restore = True
    best_val, _ = ttrain.train(cfg, device="cpu")  # resumes from the autosave
    assert not os.path.exists(autosave_dir)
    assert saved_epoch(ckpt_dir) is not None
    assert best_val > 0.0


def test_metrics_jsonl_records(synth_dir, tmp_path):
    cfg = cli_cfg(synth_dir, tmp_path, metrics_jsonl="metrics.jsonl", log_every=4)
    ttrain.train(cfg, device="cpu")
    records = [json.loads(ln) for ln in open(os.path.join(cfg.dataset.save_dir, "log", "metrics.jsonl"))]
    train_recs = [r for r in records if r["type"] == "train"]
    val_recs = [r for r in records if r["type"] == "val"]
    # 6 steps an epoch: records at steps 4 and 6 of each
    assert [r["step"] for r in train_recs] == [4, 6, 10, 12] and len(val_recs) == 2
    for r in train_recs:
        assert set(r) == TRAIN_KEYS and np.isfinite(r["ce"]) and r["lr"] > 0 and r["wall_s"] >= 0
    for r in val_recs:
        assert set(r) == VAL_KEYS and 0.0 <= r["acc"] <= 1.0 and len(r["categories"]) == 15


def test_grad_accum_logs_the_jax_lr(synth_dir, tmp_path):
    """2 micro-steps an epoch over 11 epochs: the lr halves at micro-step
    20; each record's lr is the JAX train.py's formula at its step."""
    cfg = cli_cfg(synth_dir, tmp_path, max_epochs=11, metrics_jsonl="m.jsonl", grad_accum=2, autosave=False)
    cfg.train.train_num, cfg.val.flag = 16, False
    _, state = ttrain.train(cfg, device="cpu")
    assert state.step == 22 and state.updates == 11
    recs = [json.loads(ln) for ln in open(os.path.join(cfg.dataset.save_dir, "log", "m.jsonl"))]
    sched = jax_lr_schedule(cfg.train.lr, 2)
    want = [float(sched(max((r["step"] // 2 - 1) * 2, 0))) for r in recs]
    assert [r["lr"] for r in recs] == want
    assert want[-2:] == [cfg.train.lr, cfg.train.lr / 2]


def test_data_keys_reach_the_loaders(synth_dir, tmp_path, monkeypatch):
    seen = []

    class Recording(ttrain.VideoQADataLoader):
        def __init__(self, **kw):
            seen.append(kw)
            super().__init__(**kw)

    monkeypatch.setattr(ttrain, "VideoQADataLoader", Recording)
    cfg = cli_cfg(synth_dir, tmp_path, max_epochs=1, feature_cache_gb=0.0, prefetch=3,
                     transfer_dtype="bfloat16")
    best_val, _ = ttrain.train(cfg, device="cpu")
    assert len(seen) == 2
    for kw in seen:
        assert (kw["feature_cache_gb"], kw["prefetch"], kw["transfer_dtype"], kw["pin_memory"]) == (
            0.0, 3, "bfloat16", False)


@pytest.mark.parametrize("section,key,value,error", [
    (None, "graph_module", "BOGUS", ValueError),
    ("tpu", "mesh_axis", "model", ValueError),
    ("tpu", "tensor_parallel", 2, ValueError),
    ("tpu", "zero_opt", True, None),
    ("tpu", "prng_impl", "threefry2x32", NotImplementedError),
])
def test_clis_refuse_what_the_port_does_not_build(synth_dir, tmp_path, section, key, value, error):
    """What no run can build is refused before anything is written: an
    unknown graph module, a data axis named as the model axis, a tensor
    parallel degree that does not divide the ranks (one process here), a
    JAX generator. ``zero_opt`` is accepted: in one process it has nothing
    to shard, and the run trains and saves."""
    cfg = cli_cfg(synth_dir, tmp_path, max_epochs=1)
    (cfg[section] if section else cfg)[key] = value
    if error is None:
        ttrain.train(cfg, device="cpu")
        assert os.path.exists(os.path.join(cfg.dataset.save_dir, "ckpt"))
        return
    match = {"graph_module": "unknown graph_module", "mesh_axis": "model axis",
             "tensor_parallel": "does not divide the 1 available devices"}.get(key, f"tpu.{key}")
    with pytest.raises(error, match=match):
        ttrain.train(cfg, device="cpu")
    assert not os.path.exists(os.path.join(cfg.dataset.save_dir, "ckpt"))


def test_mains_default_to_cuda_and_raise_without_it(synth_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLIs run on it")
    cfg = write_cfg(synth_dir, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--cfg", cfg, "--unit_layers", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        tvalidate.main(["--cfg", cfg, "--unit_layers", "1"])
