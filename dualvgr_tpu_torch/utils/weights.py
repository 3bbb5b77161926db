"""Weights from the JAX package's variable tree, in the reference's names.

The port's modules carry the reference's (PyTorch DualVGR-VideoQA)
``state_dict`` key names, so a reference ``*_model.pt`` loads with
``model.load_state_dict(ckpt["state_dict"])`` as it is. This module maps the
JAX package's ``{'params', 'batch_stats'}`` tree (numpy leaves) onto the
same names: its own copy of the inverse mapping in the JAX package's
``utils/port_reference.py``. Head-merged GAT kernels are split back into the
reference's per-head ``attention_{h}.W`` / ``.a`` Linears, and every
(in, out) kernel is transposed to torch's (out, in). A GCN model's banks
(``ac_gat_{k}/gc1/weight``, no bias) go to ``acGCN.{k}.gc1.weight``
untransposed: the reference's GraphConvolution weight is an (in, out)
parameter used as ``x @ W``, not a Linear. (The JAX package's own inverse
mapping reads GAT banks only.)

``backbone_from_flax`` (as ``resnet101_from_flax`` and
``resnext101_from_flax``) carries the flax variables of the JAX package's
feature-extraction backbones and 3D CNN zoo onto the port's.

``load_flax_params`` carries a flax module's params onto the port's
counterpart of any module of the zoos (``models/{decoder,encoders,
graph_zoo,attention_zoo,utils_zoo,fusions}.py``), whose submodules carry
the flax names.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _inv_linear(params, prefix, out, bias=True):
    out[f"{prefix}.weight"] = np.asarray(params["kernel"]).T
    if bias:
        out[f"{prefix}.bias"] = np.asarray(params["bias"])


def _inv_lstm(params, prefix, out):
    for sfx, d in (("", "fwd"), ("_reverse", "bwd")):
        out[f"{prefix}.weight_ih_l0{sfx}"] = np.asarray(params[f"w_ih_{d}"]).T
        out[f"{prefix}.weight_hh_l0{sfx}"] = np.asarray(params[f"w_hh_{d}"]).T
        out[f"{prefix}.bias_ih_l0{sfx}"] = np.asarray(params[f"b_ih_{d}"])
        out[f"{prefix}.bias_hh_l0{sfx}"] = np.asarray(params[f"b_hh_{d}"])


def _inv_gat(params, prefix, out):
    wk = np.asarray(params["w_kernel"])  # (D, H, hd)
    wb = np.asarray(params["w_bias"])  # (H, hd)
    a = np.asarray(params["a"])  # (H, 2hd)
    ab = np.asarray(params["a_bias"])  # (H,)
    for h in range(wk.shape[1]):
        out[f"{prefix}.attention_{h}.W.weight"] = wk[:, h, :].T
        out[f"{prefix}.attention_{h}.W.bias"] = wb[h]
        out[f"{prefix}.attention_{h}.a.weight"] = a[h : h + 1]
        out[f"{prefix}.attention_{h}.a.bias"] = ab[h : h + 1]


def _inv_bank(params, prefix, out):
    """One graph bank: a PunishGAT (``w_kernel``, ...) or a PunishGCN
    (``gc1/weight``, untransposed)."""
    if "gc1" in params:
        for name, v in params["gc1"].items():
            out[f"{prefix}.gc1.{name}"] = np.asarray(v)
    else:
        _inv_gat(params, prefix, out)


def _inv_sfgcn(params, prefix, out):
    out[f"{prefix}.project.0.weight"] = np.asarray(params["proj_kernel"]).T
    out[f"{prefix}.project.0.bias"] = np.asarray(params["proj_bias"])
    # project.2 is Linear(hidden, 1, bias=False) (reference Attention.py:14-18)
    out[f"{prefix}.project.2.weight"] = np.asarray(params["score_kernel"]).T


def _layout(vu: dict) -> tuple[int, int]:
    """(unit_layers, GAT bank count) of a ``visual_input_unit`` subtree."""
    units = sum(1 for k in vu if k.startswith("query_attn_"))
    banks = sum(1 for k in vu if k.startswith("ac_gat_"))
    return units, banks


def reference_state_dict(variables: dict) -> dict:
    """JAX ``{'params', 'batch_stats'}`` -> reference state_dict (numpy)."""
    p = variables["params"]
    sd: dict = {}

    li = p["linguistic_input_unit"]
    sd["linguistic_input_unit.encoder_embed.weight"] = np.asarray(
        li["encoder_embed"]["embedding"]
    )
    _inv_lstm(li["concat_rnn"], "linguistic_input_unit.concatRNN.rnn", sd)
    _inv_lstm(li["encoder"], "linguistic_input_unit.encoder", sd)
    _inv_lstm(
        p["visual_appearance_input_unit"]["encoder"],
        "visual_appearance_input_unit.encoder",
        sd,
    )
    _inv_linear(p["visual_motion_input_unit"]["proj"], "visual_motion_input_unit", sd)

    vu = p["visual_input_unit"]
    unit_layers, banks = _layout(vu)
    for i in range(unit_layers):
        pre = "visual_input_unit"
        _inv_linear(vu[f"query_attn_{i}"]["feat_enhance"], f"{pre}.queryAttn.{i}.feat_enhance", sd)
        _inv_linear(vu[f"query_attn_{i}"]["fc"], f"{pre}.queryAttn.{i}.fc", sd)
        _inv_linear(
            vu[f"query_punish_appear_{i}"]["query_weight"],
            f"{pre}.queryPunish_appear.{i}.query_weight",
            sd,
        )
        _inv_linear(
            vu[f"query_punish_motion_{i}"]["query_weight"],
            f"{pre}.queryPunish_motion.{i}.query_weight",
            sd,
        )
        _inv_sfgcn(vu[f"attention_appearance_{i}"], f"{pre}.attention_appearance.{i}", sd)
        _inv_sfgcn(vu[f"attention_motion_{i}"], f"{pre}.attention_motion.{i}", sd)
    for k in range(banks):
        _inv_bank(vu[f"ac_gat_{k}"], f"visual_input_unit.acGCN.{k}", sd)
        _inv_bank(vu[f"appearance_gat_{k}"], f"visual_input_unit.appearance_GCN.{k}", sd)
        _inv_bank(vu[f"mc_gat_{k}"], f"visual_input_unit.mcGCN.{k}", sd)
        _inv_bank(vu[f"motion_gat_{k}"], f"visual_input_unit.motion_GCN.{k}", sd)
    for name in ("linear0", "linear1", "linear_out"):
        _inv_linear(vu["visual_fusion"][name], f"visual_input_unit.visualfusion.{name}", sd)

    _inv_linear(p["feature_aggregation"]["v_proj"], "feature_aggregation.v_proj", sd, bias=False)
    _inv_linear(p["feature_aggregation"]["attn"], "feature_aggregation.attn", sd)

    ou = p["output_unit"]
    _inv_linear(ou["question_proj"], "output_unit.question_proj", sd)
    _inv_linear(ou["fc1"], "output_unit.classifier.1", sd)
    sd["output_unit.classifier.3.weight"] = np.asarray(ou["bn"]["scale"])
    sd["output_unit.classifier.3.bias"] = np.asarray(ou["bn"]["bias"])
    bn_stats = variables["batch_stats"]["output_unit"]["bn"]
    sd["output_unit.classifier.3.running_mean"] = np.asarray(bn_stats["mean"])
    sd["output_unit.classifier.3.running_var"] = np.asarray(bn_stats["var"])
    # torch BatchNorm1d tracks this and a strict load needs the key; the
    # value plays no part in eval math
    sd["output_unit.classifier.3.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
    _inv_linear(ou["classifier"], "output_unit.classifier.5", sd)
    return sd


def from_jax_variables(variables: dict) -> dict:
    """JAX ``{'params', 'batch_stats'}`` (numpy leaves) -> the port's
    ``state_dict`` (CPU tensors, reference key names), ready for
    ``model.load_state_dict``."""
    return {
        k: torch.tensor(np.array(v, copy=True))
        for k, v in reference_state_dict(variables).items()
    }


def load_flax_params(module: nn.Module, params: dict, batch_stats: dict | None = None,
                     extra: dict | None = None) -> dict:
    """A flax module's ``params`` (and ``batch_stats``; numpy leaves) as the
    ``state_dict`` of the port's counterpart ``module``, whose submodules
    carry the flax names: an ``nn.Linear`` takes ``kernel`` transposed and
    ``bias``, an ``nn.Conv1d`` its (k, in, out) ``kernel`` as (out, in, k),
    an ``nn.LayerNorm`` ``scale`` and ``bias``, an ``nn.Embedding``
    ``embedding``, a BiLSTM, a PunishGAT and a MaskedBatchNorm their own
    trees as the model's mapping lays them out; any other module's own
    parameters and buffers are taken by name as they are. ``extra`` (port
    names) supplies what the flax tree does not hold, as MCB's count-sketch
    vectors. Ready for ``module.load_state_dict(..., strict=True)``."""
    from dualvgr_tpu_torch.models.decoder import MaskedBatchNorm
    from dualvgr_tpu_torch.models.encoders import BiLSTM
    from dualvgr_tpu_torch.models.graph import PunishGAT

    sd: dict = {}

    def walk(mod, p, stats, prefix):
        if isinstance(mod, nn.Linear):
            _inv_linear(p, prefix[:-1], sd, bias=mod.bias is not None)
        elif isinstance(mod, nn.Conv1d):
            sd[prefix + "weight"] = np.asarray(p["kernel"]).transpose(2, 1, 0)
            sd[prefix + "bias"] = np.asarray(p["bias"])
        elif isinstance(mod, nn.LayerNorm):
            sd[prefix + "weight"], sd[prefix + "bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])
        elif isinstance(mod, nn.Embedding):
            sd[prefix + "weight"] = np.asarray(p["embedding"])
        elif isinstance(mod, BiLSTM):
            _inv_lstm(p, prefix[:-1], sd)
        elif isinstance(mod, PunishGAT):
            _inv_gat(p, prefix[:-1], sd)
        elif isinstance(mod, MaskedBatchNorm):
            sd[prefix + "weight"], sd[prefix + "bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])
            sd[prefix + "running_mean"] = np.asarray(stats["mean"])
            sd[prefix + "running_var"] = np.asarray(stats["var"])
            sd[prefix + "num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        else:
            for name, _ in list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False)):
                if name in p:
                    sd[prefix + name] = np.asarray(p[name])
            for name, child in mod.named_children():
                if next(iter(child.state_dict()), None) is not None:
                    walk(child, p.get(name, {}), (stats or {}).get(name), f"{prefix}{name}.")

    walk(module, params, batch_stats, "")
    sd.update(extra or {})
    return {k: torch.tensor(np.array(v, copy=True)) for k, v in sd.items()}


def backbone_from_flax(variables: dict) -> dict:
    """Flax variables of a backbone of the JAX package (``ResNet101``,
    ``ResNeXt101_3D``, the 3D CNN zoo; numpy leaves: HWIO or DHWIO conv
    kernels, BatchNorm scale and bias with the batch stats' mean and var,
    blocks ``layer{s}_{b}``) -> the state_dict of the port's counterpart
    (OIHW or OIDHW; ``layer{s}.{b}``, ``downsample_conv``/``_bn`` as
    ``downsample.0``/``.1``, every other name as it is), ready for
    ``load_state_dict(..., strict=True)``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict = {}

    def conv(p, key):
        k = np.asarray(p["kernel"])
        sd[f"{key}.weight"] = k.transpose(k.ndim - 1, k.ndim - 2, *range(k.ndim - 2))

    def bn(p, s, key):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = np.asarray(s["mean"]), np.asarray(s["var"])
        sd[f"{key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def walk(p, s, prefix):
        for name, sub in p.items():
            key = prefix + {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}.get(name, name)
            if "kernel" in sub:
                conv(sub, key)
            elif "scale" in sub:
                bn(sub, s[name], key)
            else:  # a block, layer{s}_{b} -> layer{s}.{b}
                stage, block = name.split("_")
                walk(sub, s[name], f"{prefix}{stage}.{block}.")

    walk(params, stats, "")
    return {k: torch.tensor(np.array(v, copy=True)) for k, v in sd.items()}


# the inverses of the JAX package's ``port_resnet101_state_dict`` and
# ``port_resnext101_state_dict``: its ResNet101 / ResNeXt101_3D variables ->
# the port's modules' state_dicts (torchvision's / the Kinetics keys)
resnet101_from_flax = resnext101_from_flax = backbone_from_flax
