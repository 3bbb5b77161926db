"""Config system: typed defaults + recursive YAML merge.

The port's own copy of the JAX package's config surface (``Config``,
``default_config``, ``_merge_into``, ``cfg_from_file``,
``resolve_dataset_paths``): the reference defaults key for key, a
type-checked YAML overlay and ``yaml.safe_load``. The three reference YAML
experiment files (configs/*.yml) parse unchanged.

There are no backend resolvers here: the device is an explicit argument of
the port's entry points (``build_model``, ``build_predict_fn``,
``BatchingEngine``), never something read from the config.
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
