"""What every driver shares: the run's context, the program's model with
the run's weights in it, the hooks that tests and the limit readings use to
break or switch the timed path, and the comparisons that decide ``correct``."""

from __future__ import annotations

import copy
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.lib.trace import Recorder


@dataclass
class Context:
    """One run of one cell."""

    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    tmpdir: str
    # "control": the program in the precision below the configuration's
    # (its bf16 streaming), which the comparison has to fail
    variant: str | None = None
    faults: tuple = ()  # faults planted under the timed path (see ``hook``)
    readings_only: bool = False  # no window: set-up, the checked work and the comparison
    rec: Recorder = None
    log: list = field(default_factory=list)
    stages: list = field(default_factory=list)  # (name, perf_counter at its end)
    readings: dict = field(default_factory=dict)  # every number the comparison read

    def __post_init__(self):
        if self.rec is None:
            w = self.workload
            self.rec = Recorder(self.trace, self.device, w["trace_from"] * self.seconds,
                                w["trace_to"] * self.seconds)

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def compute_dtype(self) -> str:
        return "bfloat16" if self.variant == "control" else self.model["compute_dtype"]

    def stage(self, name: str) -> None:
        """Marks the end of a stage of set-up, for the log."""
        self.stages.append((name, time.perf_counter()))

    def say(self, line: str) -> None:
        """A line for standard error, before the result."""
        self.log.append(line)

    def hook(self, name: str, fn):
        """``fn``, the program's call that the window drives, or ``fn``
        with this run's faults planted in it."""
        for fault in self.faults:
            fn = FAULTS[fault](name, fn, self)
        return fn


def build_program_model(ctx: Context, weights: dict):
    """The program's DualVGR on the card with the run's weights: built by
    its own ``build_model`` (kernels on), then ``load_state_dict``."""
    from dualvgr_tpu_torch.models.dualvgr import build_model

    m = ctx.model
    model = build_model(device=ctx.device, use_kernels=True, compute_dtype=ctx.compute_dtype,
                        vision_dim=m["vision_dim"], module_dim=m["module_dim"], word_dim=m["word_dim"],
                        question_vocab_size=m["question_vocab_size"], num_answers=m["num_answers"],
                        num_of_nodes=m["num_of_nodes"], graph_layers=m["graph_layers"],
                        unit_layers=m["unit_layers"], graph_module=m["graph_module"])
    model.load_state_dict(weights, strict=True)
    return model


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- checks

def check(name: str, value: float, limit: float) -> dict:
    """One number compared, with its limit; a number that is not finite fails."""
    value = float(value)
    return {"name": name, "value": value, "limit": float(limit),
            "ok": bool(np.isfinite(value) and value <= limit)}


def checks_of(ctx: Context, readings: dict) -> list:
    """The readings that the cell's file gives a limit, each with it; all
    of them go to the log."""
    ctx.readings.update(readings)
    limits = ctx.workload["limits"]
    return [check(k, v, limits[k]) for k, v in readings.items() if k in limits]


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """Each leaf's gap between two norms, |prog - ref|, over the larger of
    the reference's norm of that leaf and of its median leaf."""
    keys = list(ref) if keys is None else list(keys)
    median = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def logit_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """The widest gap by which the reference's logit of a chosen answer
    lies below the reference's logit of the same rank, over the row's
    largest |logit|: ``chosen`` (N,) the answer of each row, or (N, k) its
    top k in order."""
    ref = ref_logits.double()
    chosen = chosen.long().view(ref.shape[0], -1)
    best = ref.topk(chosen.shape[1], dim=1).values
    gap = best - ref.gather(1, chosen)
    return float((gap / ref.abs().max(dim=1, keepdim=True).values.clamp(min=1e-30)).max())


def score_gap(ref_logits: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor) -> float:
    """The widest gap between a served score and the reference's softmax
    probability of the same answer, over the row's best probability."""
    p = torch.softmax(ref_logits.double(), dim=1)
    want = p.gather(1, ids.long())
    return float(((scores.double() - want).abs() / p.max(dim=1, keepdim=True).values).max())


# ---------------------------------------------------------------- faults

def _unchanged(name, fn, ctx):
    """A train step that leaves the parameters and the optimizer as they were."""
    if name != "train_step":
        return fn

    def step(state, batch, **kw):
        params = [p.detach().clone() for p in state.model.parameters()]
        adam = copy.deepcopy(state.adam.state_dict())
        out = fn(state, batch, **kw)
        with torch.no_grad():
            for p, saved in zip(state.model.parameters(), params):
                p.copy_(saved)
        state.adam.load_state_dict(adam)
        return out

    return step


def _half(name, fn, ctx):
    """Half of the batch left out of the step: the mean over the rest."""
    if name != "train_step":
        return fn

    def step(state, batch, **kw):
        valid = torch.as_tensor(batch[5]).clone()
        valid[valid.shape[0] // 2:] = 0
        return fn(state, (*batch[:5], valid), **kw)

    return step


def _answer(name, fn, ctx):
    """One answer altered where it is produced."""
    answers = ctx.model["num_answers"]
    if name == "pred_step":
        def pred(*args):
            out = fn(*args).clone()
            out[0] = (out[0] + 1) % answers
            return out
        return pred
    if name == "predict":
        def predict(*args):
            ids, scores = fn(*args)
            ids = ids.copy()
            ids[0, 0] = (ids[0, 0] + 1) % answers
            return ids, scores
        return predict
    return fn


FAULTS = {"unchanged": _unchanged, "half": _half, "answer": _answer}
