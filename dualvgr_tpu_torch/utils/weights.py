"""Weights from the JAX package's variable tree, in the reference's names.

The port's modules carry the reference's (PyTorch DualVGR-VideoQA)
``state_dict`` key names, so a reference ``*_model.pt`` loads with
``model.load_state_dict(ckpt["state_dict"])`` as it is. This module maps the
JAX package's ``{'params', 'batch_stats'}`` tree (numpy leaves) onto the
same names: its own copy of the inverse mapping in the JAX package's
``utils/port_reference.py``. Head-merged GAT kernels are split back into the
reference's per-head ``attention_{h}.W`` / ``.a`` Linears, and every
(in, out) kernel is transposed to torch's (out, in).
"""

from __future__ import annotations

import numpy as np
import torch


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
        _inv_gat(vu[f"ac_gat_{k}"], f"visual_input_unit.acGCN.{k}", sd)
        _inv_gat(vu[f"appearance_gat_{k}"], f"visual_input_unit.appearance_GCN.{k}", sd)
        _inv_gat(vu[f"mc_gat_{k}"], f"visual_input_unit.mcGCN.{k}", sd)
        _inv_gat(vu[f"motion_gat_{k}"], f"visual_input_unit.motion_GCN.{k}", sd)
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
