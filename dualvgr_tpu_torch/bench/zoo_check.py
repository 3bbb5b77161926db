"""Every class of the port's zoos on a device against the same module on the CPU.

    python -m dualvgr_tpu_torch.bench.zoo_check [--device cuda]

The zoos (``models/{decoder,encoders,graph_zoo,attention_zoo,utils_zoo,
fusions}.py``: the decoder and question-encoder variants, the graph,
attention and model-utils zoos, every fusion) have no kernel: each runs as
plain PyTorch on whatever device its tensors are on. ``check_zoo`` builds
each at a small width on the CPU (seeded), copies it to ``device``, runs
the same seeded inputs through both in eval mode, and holds the device's
outputs within ``TOL`` x max(1, max|CPU output|) of the CPU's (fp32; TF32
must be off). While the device runs, a ``TorchFunctionMode`` records every
tensor a torch function returns on the CPU: none may (a mask or an index
built on the CPU would show there). ``chip_smoke.py`` (phase ``zoo``) and
the card tests run it on the card.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from dualvgr_tpu_torch.models import attention_zoo as A
from dualvgr_tpu_torch.models import decoder as D
from dualvgr_tpu_torch.models import encoders as E
from dualvgr_tpu_torch.models import fusions as FU
from dualvgr_tpu_torch.models import graph_zoo as G
from dualvgr_tpu_torch.models import utils_zoo as U
from dualvgr_tpu_torch.models.graph import dense_self_loop_adjacency
from dualvgr_tpu_torch.utils.device import resolve_device

TOL = 1e-5


def _f(r, *shape):
    return torch.from_numpy(r.randn(*shape).astype(np.float32))


def _tokens(r, b=3, t=6, vocab=20):
    qlen = r.randint(1, t + 1, (b,))
    qlen[0] = t
    q = r.randint(1, vocab, (b, t))
    q[np.arange(t)[None, :] >= qlen[:, None]] = 0
    return torch.from_numpy(q), torch.from_numpy(qlen)


def _mask(b, lq, lk):
    m = torch.zeros(b, lq, lk, dtype=torch.bool)
    m[:, :, 0] = True
    return m


def _rows():
    return torch.tensor([[1.0] * 4, [1.0] * 3 + [0.0]])


def _with_stats(m):
    bn = m.bn
    bn.running_mean.normal_(0.0, 0.3)
    bn.running_var.uniform_(0.5, 1.5)
    return m


def _fusion(name, **kw):
    return lambda: FU.fusion_factory(name, input_dims=(10, 12), output_dim=24, **kw)


# name -> (module factory or plain function, inputs from a numpy RandomState)
CASES = {
    "decoder.ConcatELUAttn": (lambda: D.ConcatELUAttn(16), lambda r: (_f(r, 3, 16), _f(r, 3, 5, 16))),
    "decoder.MFBAttn": (lambda: D.MFBAttn(16), lambda r: (_f(r, 3, 16), _f(r, 3, 5, 16))),
    "decoder.SimpleConcatELUAttn": (lambda: D.SimpleConcatELUAttn(16), lambda r: (_f(r, 3, 16), _f(r, 3, 5, 16))),
    "decoder.GateOutputUnitOpenEnded": (lambda: _with_stats(D.GateOutputUnitOpenEnded(16, 7)),
                                        lambda r: (_f(r, 4, 16), _f(r, 4, 16))),
    "encoders.SimpleQuestionEncoder": (lambda: E.SimpleQuestionEncoder(20, 10, 16), _tokens),
    "encoders.MultiGranularQuestionEncoder": (lambda: E.MultiGranularQuestionEncoder(20, 10, 12), _tokens),
    "graph_zoo.GAT": (lambda: G.GAT(4, 4, 16), lambda r: (_f(r, 3, 5, 16), dense_self_loop_adjacency(5))),
    "graph_zoo.construct_graph": (lambda: lambda x: G.construct_graph(x, 3), lambda r: (_f(r, 9, 12),)),
    "graph_zoo.process_adj": (lambda: G.process_adj,
                              lambda r: (torch.from_numpy((r.rand(6, 6) > 0.5).astype(np.float32)),)),
    "graph_zoo.GINLayer": (lambda: G.GINLayer(8, 8, num_hop=2, num_rel=3),
                           lambda r: (_f(r, 2, 4, 8), _rows(),
                                      torch.from_numpy(r.rand(2, 3, 4, 4).astype(np.float32)))),
    "graph_zoo.GatedGATLayer": (lambda: G.GatedGATLayer(8, 8, num_hop=2),
                                lambda r: (_f(r, 2, 4, 8), _rows(),
                                           torch.from_numpy((r.rand(2, 2, 4, 4) * (r.rand(2, 2, 4, 4) > 0.3))
                                                            .astype(np.float32)))),
    "graph_zoo.GatedGCNLayer": (lambda: G.GatedGCNLayer(8, 8),
                                lambda r: (_f(r, 2, 4, 8), torch.from_numpy(r.rand(2, 2, 4, 4).astype(np.float32)))),
    "attention_zoo.ScaledDotProductAttention": (lambda: A.ScaledDotProductAttention(8 ** 0.5),
                                                lambda r: (_f(r, 3, 5, 8), _f(r, 3, 7, 8), _f(r, 3, 7, 6),
                                                           _mask(3, 5, 7))),
    "attention_zoo.MultiHeadAttention": (lambda: A.MultiHeadAttention(4, 16, 8, 6),
                                         lambda r: (*(_f(r, 2, 6, 16),) * 3, _mask(2, 6, 6))),
    "attention_zoo.PositionwiseFeedForward": (lambda: A.PositionwiseFeedForward(16, 32), lambda r: (_f(r, 2, 5, 16),)),
    "attention_zoo.EncoderLayer": (lambda: A.EncoderLayer(16, 32, 2, 8, 8),
                                   lambda r: (*(_f(r, 2, 5, 16),) * 3, torch.ones(2, 5, 1), _mask(2, 5, 5))),
    "attention_zoo.AttentionC": (lambda: A.AttentionC(20, 12, head=4), lambda r: (_f(r, 3, 1, 12), _f(r, 3, 20))),
    "attention_zoo.RNNEncoder": (lambda: A.RNNEncoder(10, 6), lambda r: (_f(r, 4, 7, 10), torch.tensor([7, 3, 1, 0]))),
    "attention_zoo.RNNEncoder_unidirectional": (lambda: A.RNNEncoder(10, 6, bidirectional=False),
                                                lambda r: (_f(r, 4, 7, 10), torch.tensor([7, 3, 1, 0]))),
    "attention_zoo.TanhAttention": (lambda: A.TanhAttention(8), lambda r: (_f(r, 2, 5, 8), _f(r, 2, 4, 8))),
    "attention_zoo.TanhAttention_forward": (lambda: A.TanhAttention(8, direction="forward"),
                                            lambda r: (_f(r, 2, 5, 8), _f(r, 2, 5, 8),
                                                       torch.tensor([[1, 1, 1, 1, 0], [1] * 5]))),
    "attention_zoo.TanhAttention_backward": (lambda: A.TanhAttention(8, direction="backward"),
                                             lambda r: (_f(r, 2, 5, 8), _f(r, 2, 5, 8),
                                                        torch.tensor([[1, 1, 1, 1, 0], [1] * 5]))),
    "attention_zoo.WordAttention": (lambda: A.WordAttention(8),
                                    lambda r: (_f(r, 3, 6, 8), _f(r, 3, 6, 5), _tokens(r)[0])),
    "attention_zoo.GatedNLT": (lambda: A.GatedNLT(10, 6), lambda r: (_f(r, 4, 10),)),
    "utils_zoo.l2norm": (lambda: U.l2norm, lambda r: (_f(r, 2, 3, 8),)),
    "utils_zoo.VisualEnhanceByQuery": (lambda: U.VisualEnhanceByQuery(16),
                                       lambda r: (_f(r, 2, 6, 16), _f(r, 2, 4, 16))),
    "fusions.MLP": (lambda: FU.MLP(10, (8, 6, 4), activation="tanh"), lambda r: (_f(r, 3, 10),)),
    "fusions.power_normalize": (lambda: FU.power_normalize, lambda r: (_f(r, 4, 9),)),
    **{f"fusions.{name}": (_fusion(name, **kw), lambda r: (_f(r, 3, 10), _f(r, 3, 12))) for name, kw in (
        ("block", dict(mm_dim=40, chunks=4, rank=3)), ("block_tucker", dict(mm_dim=40, chunks=4)),
        ("mutan", dict(mm_dim=16, rank=3)), ("tucker", dict(mm_dim=16, normalize=True)),
        ("mlb", dict(mm_dim=7, normalize=True)), ("mfb", dict(mm_dim=8)), ("mfh", dict(mm_dim=8, normalize=True)),
        ("mcb", dict(mm_dim=64)), ("linear_sum", dict(mm_dim=20)), ("cat_mlp", dict(dimensions=(16, 12))),
    )},
}


class _CpuResults(TorchFunctionMode):
    """Records the torch functions that return a CPU tensor."""

    def __init__(self):
        super().__init__()
        self.cpu = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in leaves):
            self.cpu.append(getattr(func, "__name__", str(func)))
        return out


def _leaves(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,)) if isinstance(t, torch.Tensor)]


def check_zoo(device="cuda", seed=0) -> dict:
    """{case: max |device - CPU| / max(1, max|CPU|)} over every case; raises
    if a case's outputs differ beyond ``TOL``, are not finite, or if a torch
    function returned a CPU tensor while the device ran."""
    dev = resolve_device(device)
    errs = {}
    for name, (make, make_inputs) in CASES.items():
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fn = make()
        args = make_inputs(np.random.RandomState(seed))
        if isinstance(fn, torch.nn.Module):
            fn = fn.eval()
            fn_dev = copy.deepcopy(fn).to(dev)
        else:
            fn_dev = fn
        args_dev = [a.to(dev) for a in args]
        with torch.no_grad():
            want = _leaves(fn(*args))
            with _CpuResults() as mode:
                got = _leaves(fn_dev(*args_dev))
        if dev.type != "cpu" and mode.cpu:
            raise RuntimeError(f"zoo {name}: torch functions returned CPU tensors on {dev}: {sorted(set(mode.cpu))}")
        if len(got) != len(want):
            raise RuntimeError(f"zoo {name}: {len(got)} outputs against {len(want)}")
        err = 0.0
        for g, w in zip(got, want):
            if g.device.type != dev.type or g.shape != w.shape or not torch.isfinite(g.float()).all():
                raise RuntimeError(f"zoo {name}: output on {g.device}, shape {tuple(g.shape)} (CPU {tuple(w.shape)})")
            scale = max(1.0, w.float().abs().max().item())
            err = max(err, (g.cpu().float() - w.float()).abs().max().item() / scale)
        if not err <= TOL:
            raise RuntimeError(f"zoo {name}: {err:.3e} relative to the CPU's output, beyond {TOL}")
        errs[name] = err
    return errs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = check_zoo(args.device)
    print(json.dumps({"cases": len(errs), "max_rel_err": max(errs.values()), "errs": errs}))


if __name__ == "__main__":
    main()
