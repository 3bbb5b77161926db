"""Config system: typed defaults + recursive YAML merge.

The port's own copy of the JAX package's config surface (``Config``,
``default_config``, ``_merge_into``, ``cfg_from_file``,
``resolve_dataset_paths``): the reference defaults key for key, the JAX
package's ``tpu`` section key for key, a type-checked YAML overlay and
``yaml.safe_load``. The three reference YAML experiment files
(configs/*.yml) parse unchanged, and so does any YAML the JAX package's
``cfg_from_file`` accepts.

The resolvers (``resolved_compute_dtype``, ``resolved_use_kernels``,
``model_runtime_kwargs``) take the device explicitly: the device is an
argument of the port's entry points (``build_model``, ``build_predict_fn``,
``BatchingEngine``, the train and validate CLIs), never something read
from the config. Of the ``tpu`` keys, ``compute_dtype`` and ``use_pallas``
(as ``use_kernels``) are model arguments; the data and CLI keys
(``feature_cache_gb``, ``prefetch``, ``transfer_dtype``, ``log_every``,
``profile_dir``, ``grad_accum``, ``autosave``, ``metrics_jsonl``) are read
by ``dualvgr_tpu_torch.train`` and ``.validate``; the multi-device keys
(``mesh_axis``, ``tensor_parallel``, ``zero_opt``) by
``parallel.tp.mesh_for`` and ``place_state`` through the same CLIs, and
``tensor_parallel > 1`` turns the kernels off (``model_runtime_kwargs``);
``prng_impl`` may only be "auto".
"""

from __future__ import annotations

import copy
import os
from typing import Any

import numpy as np
import yaml


class Config(dict):
    """dict with attribute access (replacement for easydict.EasyDict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        """Recursively convert nested dicts to Config."""
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


def default_config() -> Config:
    """Typed defaults, key-for-key with the reference (config.py:7-56)."""
    return Config.wrap({
        "gpu_id": 0,
        "num_workers": 4,
        "multi_gpus": False,
        "seed": 666,
        "model_type": "baseline",
        "graph_module": "GCN",
        "graph_layers": 1,
        "train": {
            "restore": False,
            "lr": 0.0001,
            "batch_size": 32,
            "max_epochs": 25,
            "vision_dim": 2048,
            "word_dim": 300,
            "module_dim": 768,
            "train_num": 0,  # 0 => full train set
            "glove": True,
            "num_of_nodes": 8,
        },
        "val": {
            "flag": True,
            "val_num": 0,  # 0 => full val set
        },
        "test": {
            "test_num": 0,  # 0 => full test set
            "write_preds": False,
        },
        "dataset": {
            "name": "svqa",  # ['svqa', 'msrvtt-qa', 'msvd-qa']
            "data_dir": "",
            "appearance_feat": "{}_appearance_feat.h5",
            "motion_feat": "{}_motion_feat.h5",
            "vocab_json": "{}_vocab.json",
            "train_question_pt": "{}_train_questions.pt",
            "val_question_pt": "{}_val_questions.pt",
            "test_question_pt": "{}_test_questions.pt",
            "save_dir": "",
        },
        "exp_name": "defaultExp",
        # the JAX package's backend knobs (its config.py:98-169), key for key
        "tpu": {
            # matmul operand dtype: "auto", "float32" or "bfloat16"
            # (resolved_compute_dtype)
            "compute_dtype": "auto",
            "mesh_axis": "data",
            "feature_cache_gb": 8.0,
            "prefetch": 2,
            "transfer_dtype": "float32",
            # the hand-written kernels: "auto", or a bool that pins them
            # (resolved_use_kernels)
            "use_pallas": "auto",
            "log_every": 1,
            "profile_dir": "",
            "tensor_parallel": 1,
            "zero_opt": False,
            "grad_accum": 1,
            "prng_impl": "auto",
            "autosave": True,
            "metrics_jsonl": "",
        },
    })


def _merge_into(yaml_cfg: dict, cfg: Config, path: str = "") -> None:
    """Recursive type-checked merge (behavioral port of config.py:59-91)."""
    if not isinstance(yaml_cfg, dict):
        raise TypeError(f"expected dict at {path or '<root>'}, got {type(yaml_cfg)}")
    for k, v in yaml_cfg.items():
        kpath = f"{path}.{k}" if path else k
        if k not in cfg:
            raise KeyError(f"{kpath} is not a valid config key")
        old = cfg[k]
        if isinstance(old, dict):
            _merge_into(v, old, kpath)
            continue
        # type check with the same numpy coercion affordances as the reference
        if old is not None and v is not None and type(old) is not type(v):
            if isinstance(old, np.ndarray):
                v = np.array(v, dtype=old.dtype)
            elif isinstance(old, float) and isinstance(v, int):
                v = float(v)
            elif isinstance(old, bool) and isinstance(v, int) and v in (0, 1):
                v = bool(v)
            elif kpath == "tpu.use_pallas" and isinstance(v, bool):
                pass  # the "auto" default may be overridden by an explicit bool
            else:
                raise ValueError(
                    f"type mismatch for {kpath}: config has {type(old).__name__}, "
                    f"yaml has {type(v).__name__}"
                )
        cfg[k] = v


def cfg_from_file(filename: str, cfg: Config | None = None) -> Config:
    """Load a YAML experiment file and merge it over the defaults."""
    base = cfg if cfg is not None else default_config()
    with open(filename, "r") as f:
        yaml_cfg = yaml.safe_load(f)
    if yaml_cfg:
        _merge_into(yaml_cfg, base)
    return base


def _device_type(device) -> str:
    import torch

    return torch.device(device).type


def resolved_compute_dtype(cfg: Config, device) -> str:
    """``cfg.tpu.compute_dtype`` for a model on ``device``: an explicit
    "float32" or "bfloat16" wins; "auto" is "float32" on every device.

    The JAX package resolves "auto" to "bfloat16" on a TPU because there an
    fp32 matmul at default precision already runs as one bf16 pass, so
    streaming bf16 operands changes no number. On the H100 an fp32 matmul
    is true fp32 (the port keeps TF32 off), so bf16 streaming rounds where
    fp32 does not and changes the numbers: the port takes it only when a
    config asks for it. ``device`` is taken for the same signature as
    ``resolved_use_kernels``; the answer does not depend on it.
    """
    del device
    v = cfg.tpu.get("compute_dtype", "auto")
    if v == "auto":
        return "float32"
    if v not in ("float32", "bfloat16"):
        raise ValueError(f"tpu.compute_dtype must be 'auto', 'float32' or 'bfloat16', got {v!r}")
    return v


def resolved_use_kernels(cfg: Config, device) -> bool:
    """``cfg.tpu.use_pallas`` for a model on ``device``: an explicit bool
    wins; "auto" is on exactly for a CUDA device (the kernels run only
    there; on a CPU tensor each wrapper runs its plain version anyway)."""
    v = cfg.tpu.use_pallas
    if isinstance(v, bool):
        return v
    if v != "auto":
        raise ValueError(f"tpu.use_pallas must be 'auto' or a bool, got {v!r}")
    return _device_type(device) == "cuda"


def model_runtime_kwargs(cfg: Config, device) -> dict:
    """The ``cfg.tpu`` knobs that are ``build_model`` arguments, for a model
    on ``device``: ``{"use_kernels": ..., "compute_dtype": ...}``.

    Under tensor parallelism (``tensor_parallel > 1``) the kernels are off,
    with the JAX package's warning: the port's kernels take whole weights
    and whole rows, as a ``pallas_call`` is opaque to the SPMD partitioner
    there, so the sharded layers run the plain path. Raises if
    ``prng_impl`` names one of JAX's generators."""
    prng = cfg.tpu.get("prng_impl", "auto")
    if prng != "auto":
        raise NotImplementedError(
            f"tpu.prng_impl={prng!r} names a JAX random-number generator (threefry2x32, rbg), which "
            "torch does not have: the port draws dropout from a torch.Generator; leave it at 'auto'"
        )
    tp = int(cfg.tpu.get("tensor_parallel", 1))
    kernels = resolved_use_kernels(cfg, device)
    if kernels and tp > 1:
        import logging

        logging.warning(
            "tpu.tensor_parallel=%d forces the plain (non-kernel) execution path: the hand-written "
            "kernels take whole weights, so they do not compose with tensor parallelism. Set "
            "tensor_parallel: 1 to get the kernels back.",
            tp,
        )
    return {
        "use_kernels": kernels and tp <= 1,
        "compute_dtype": resolved_compute_dtype(cfg, device),
    }


def resolve_dataset_paths(cfg: Config) -> Config:
    """Template dataset filenames under data_dir (reference train.py:411-422)
    as ``{data_dir}/{name}_<artifact>``."""
    c = copy.deepcopy(cfg)
    name = c.dataset.name
    d = c.dataset.data_dir
    for key in (
        "appearance_feat",
        "motion_feat",
        "vocab_json",
        "train_question_pt",
        "val_question_pt",
        "test_question_pt",
    ):
        c.dataset[key] = os.path.join(d, c.dataset[key].format(name))
    return c
