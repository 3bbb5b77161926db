"""Checkpoint interchange with the reference DualVGR-VideoQA (PyTorch).

The port's counterpart of the JAX package's ``utils/port_reference.py``
CLI:

    python -m dualvgr_tpu_torch.utils.port_reference import <ref_model.pt> <ckpt_dir> \
        [--num_of_nodes N] [--device cuda|cpu]
    python -m dualvgr_tpu_torch.utils.port_reference export <ckpt_dir> <ref_model.pt> [--device cuda|cpu]

``import`` turns a reference ``*_model.pt`` into a port checkpoint
directory (``<ckpt_dir>/model/{state.pt, model_kwargs.json, meta.json}``,
as ``python -m dualvgr_tpu_torch.train`` writes under
``{save_dir}/{exp_name}/ckpt``) that serve, export and validate load. The
port's modules carry the reference's state_dict names, so the weights go
in as they are (``utils/checkpoint.py::load_reference_checkpoint``); a
strict ``load_state_dict`` into a model of the inferred size, built on
``--device`` (the card unless ``--device cpu``; no fallback), is the
structural check. unit_layers and graph_layers are inferred from the
weights (the reference trainer never forwards ``--unit_layers``, so a
reference checkpoint's model_kwargs cannot be trusted for them), the vocab
sizes from the embedding and the classifier, the other sizes from the
checkpoint's model_kwargs or the weights; ``num_of_nodes``, which no
weight records, from the model_kwargs or ``--num_of_nodes``. Adam starts
fresh: the reference's optimizer state is not carried over, as in the JAX
package.

``export`` checks a port checkpoint the same way and writes its weights
as a reference ``.pt``: ``{'epoch', 'state_dict', 'optimizer': None,
'model_kwargs'}`` with the reference's model_kwargs keys (no
unit_layers). Import then export gives the same state_dict bit for bit.
"""

from __future__ import annotations

import argparse
import os

import torch

from dualvgr_tpu_torch.models.dualvgr import build_model
from dualvgr_tpu_torch.train_lib import create_train_state, make_optimizer
from dualvgr_tpu_torch.utils.checkpoint import load_model_kwargs, load_reference_checkpoint, save_checkpoint
from dualvgr_tpu_torch.utils.device import resolve_device

REFERENCE_KWARGS = ("vision_dim", "module_dim", "word_dim", "num_of_nodes", "graph_module", "graph_layers")


def infer_unit_layers(sd: dict) -> int:
    """unit_layers from a reference state_dict (the queryAttn bank count)."""
    units = {int(k.split(".")[2]) for k in sd
             if k.startswith("visual_input_unit.queryAttn.") and k.endswith(".fc.weight")}
    if not units:
        raise ValueError("no visual_input_unit.queryAttn.* keys: not a DualVGR state_dict")
    return max(units) + 1


def infer_gat_banks(sd: dict) -> int:
    """GAT bank count (= unit_layers * graph_layers) from the acGCN keys."""
    banks = {int(k.split(".")[2]) for k in sd
             if k.startswith("visual_input_unit.acGCN.") and k.endswith(".attention_0.W.weight")}
    if not banks:
        raise ValueError("no visual_input_unit.acGCN.* keys: not a DualVGR state_dict")
    return max(banks) + 1


def _weight(sd, key):
    if key not in sd:
        raise ValueError(f"state_dict lacks {key!r}: not a DualVGR state_dict")
    return sd[key]


def checked_model(sd: dict, kwargs: dict, device):
    """A model of ``kwargs``' sizes (the vocab sizes from the weights) on
    ``device`` with ``sd`` loaded strictly: raises on a missing, extra or
    misshapen weight."""
    if kwargs.get("graph_module", "GAT") != "GAT":
        raise ValueError(
            f"graph_module={kwargs['graph_module']!r}: a reference checkpoint holds GAT banks only (the "
            "reference builds no GCN weights, and the JAX package's converter builds GAT banks only), so a "
            "GCN model has no reference .pt form; keep it as a port checkpoint")
    model = build_model(
        device=device, use_kernels=False,
        question_vocab_size=int(_weight(sd, "linguistic_input_unit.encoder_embed.weight").shape[0]),
        num_answers=int(_weight(sd, "output_unit.classifier.5.weight").shape[0]),
        unit_layers=int(kwargs.get("unit_layers", infer_unit_layers(sd))),
        **{k: kwargs[k] for k in ("vision_dim", "module_dim", "word_dim", "num_of_nodes", "graph_layers")},
    )
    model.load_state_dict(sd, strict=True)
    return model


def convert_reference_checkpoint(pt_path: str, ckpt_dir: str, num_of_nodes: int | None = None, *,
                                 device="cuda") -> dict:
    """Reference ``*_model.pt`` -> port checkpoint under ``ckpt_dir``,
    checked on ``device``. Returns the saved model_kwargs."""
    device = resolve_device(device)
    sd, ref_kwargs = load_reference_checkpoint(pt_path)
    epoch = int(torch.load(pt_path, map_location="cpu", weights_only=True).get("epoch", 0))
    emb = _weight(sd, "linguistic_input_unit.encoder_embed.weight")
    motion_w = _weight(sd, "visual_motion_input_unit.weight")
    unit_layers = infer_unit_layers(sd)
    banks = infer_gat_banks(sd)
    if banks % unit_layers:
        raise ValueError(f"{banks} GAT banks is not a multiple of unit_layers={unit_layers}")
    graph_layers = banks // unit_layers
    if "graph_layers" in ref_kwargs and int(ref_kwargs["graph_layers"]) != graph_layers:
        raise ValueError(f"checkpoint model_kwargs say graph_layers={ref_kwargs['graph_layers']} but the weights "
                         f"hold {banks} banks for unit_layers={unit_layers} (= graph_layers {graph_layers})")
    kwargs = {
        "vision_dim": int(ref_kwargs.get("vision_dim", motion_w.shape[1])),
        "module_dim": int(ref_kwargs.get("module_dim", motion_w.shape[0])),
        "word_dim": int(ref_kwargs.get("word_dim", emb.shape[1])),
        "num_of_nodes": int(num_of_nodes if num_of_nodes is not None else ref_kwargs.get("num_of_nodes", 0)),
        "graph_module": str(ref_kwargs.get("graph_module", "GAT")),
        "graph_layers": graph_layers,
        "unit_layers": unit_layers,
    }
    if kwargs["num_of_nodes"] <= 0:
        raise ValueError("num_of_nodes is not recorded in this checkpoint's model_kwargs and cannot be inferred "
                         "from weights; pass --num_of_nodes (= the num_clips the features were extracted with: "
                         "8 msvd / 16 msrvtt / 20 svqa)")
    state = create_train_state(checked_model(sd, kwargs, device), make_optimizer(1e-4, 1))
    save_checkpoint(ckpt_dir, epoch, state, kwargs)
    return kwargs


def convert_to_reference(ckpt_dir: str, pt_path: str, *, device="cuda") -> dict:
    """Port checkpoint under ``ckpt_dir``, checked on ``device`` ->
    reference ``*_model.pt``. Returns the model_kwargs written."""
    device = resolve_device(device)
    ck = torch.load(os.path.join(ckpt_dir, "model", "state.pt"), map_location="cpu", weights_only=True)
    kw = load_model_kwargs(ckpt_dir)
    checked_model(ck["state_dict"], kw, device)
    ref_kwargs = {k: kw[k] for k in REFERENCE_KWARGS if k in kw}
    torch.save({"epoch": int(ck.get("epoch", 0)), "state_dict": ck["state_dict"], "optimizer": None,
                "model_kwargs": ref_kwargs}, pt_path)
    return ref_kwargs


def main(argv=None):
    ap = argparse.ArgumentParser(description="Checkpoint interchange with the reference DualVGR-VideoQA")
    sub = ap.add_subparsers(dest="cmd", required=True)
    imp = sub.add_parser("import", help="reference *_model.pt -> port checkpoint dir")
    imp.add_argument("pt_path")
    imp.add_argument("ckpt_dir")
    imp.add_argument("--num_of_nodes", type=int, default=None,
                     help="num_clips of the features (only for checkpoints whose model_kwargs lack it)")
    exp = sub.add_parser("export", help="port checkpoint dir -> reference *_model.pt")
    exp.add_argument("ckpt_dir")
    exp.add_argument("pt_path")
    for sp in (imp, exp):
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the weights are checked (default: the card)")
    args = ap.parse_args(argv)
    if args.cmd == "import":
        kw = convert_reference_checkpoint(args.pt_path, args.ckpt_dir, args.num_of_nodes, device=args.device)
        print(f"wrote {args.ckpt_dir}: {kw}")
    else:
        kw = convert_to_reference(args.ckpt_dir, args.pt_path, device=args.device)
        print(f"wrote {args.pt_path}: {kw}")
    return kw


if __name__ == "__main__":
    main()
