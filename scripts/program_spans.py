"""Runs one benchmark cell traced, with the port's own spans placed on the
card's clock beside the harness's, and writes what they read.

    python3 scripts/program_spans.py --workload msvd-qa.train --seed 7 [--seconds 10] [--out DIR]

from the root of a checkout, on a CUDA card. It is the benchmark's
``--trace 1`` run (``perfbench/run.py``) with its ``Recorder`` replaced by
``ProgramSpans``, which turns the port's tracer
(``dualvgr_tpu_torch/utils/trace.py``) on after the first marker kernel
and off before the last, and gives the breakdown the spans of the thread
that ran the window's steps beside the harness's: the card's idle gaps are
labelled by the innermost span, the program's or the harness's, that the
launching thread was in. A span of another thread (the loader's producer)
never labels a gap. The benchmark's result line is printed as the run
prints it, its breakdown so relabelled; ``readings`` (below) go to
standard error and to ``DIR/<cell>.<seed>.json`` (default
``chiprun_out/program_spans``).

The benchmark's own files are not changed: the cells' per-layer metrics
are read as in any traced run, from the harness's spans, which keep their
names. A span is a ``record_function`` range, which the profile may also
show on the card's timeline; such ranges are not the card's work and are
left out of it (``annotations_dropped`` counts them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from perfbench.lib import harness  # noqa: E402
from perfbench.lib import trace as harness_trace  # noqa: E402
from perfbench.lib.trace import Recorder  # noqa: E402

from dualvgr_tpu_torch.utils import trace  # noqa: E402

# a train step's host phases: the three of an eager or captured step, or
# the replay of a captured one
PHASES = ("train.forward", "train.backward", "train.optimizer", "train.graph_replay")
BETWEEN = ("validate.fetch", "prefetch.copy", "loader.get")  # what a gap between two eval calls holds


def with_program(harness_spans: list, program: list, thread: int) -> list:
    """The harness's spans (name, t0, t1), seconds on ``time.perf_counter``,
    with the program's spans that ran on ``thread``."""
    return list(harness_spans) + [(s.name, s.start_ns / 1e9, s.end_ns / 1e9) for s in program if s.thread == thread]


def readings(harness_spans: list, program: list, counters: dict, kernels: list, idle_gaps: list) -> dict:
    """What the program's spans and counters read over the traced window.

    ``spans``: each program span's count, mean and total; ``phases_of_train_step``:
    the train step's host phases (its forward, backward and optimizer, or
    its graph's replay) over the harness's ``train_step`` span;
    ``replay_share``: the steps a CUDA graph took (``train.graph_replays``)
    over all steps (those and ``train.eager_steps``);
    ``between``: the program spans that start inside the harness's
    ``eval.between`` intervals, by name, and their share of those intervals;
    ``h2d_gbps``: ``prefetch.bytes`` over the window's host-to-device copies
    on the card; ``idle_in_program``: of the idle labelled ``train_step`` or
    by a train-step span (a forward's ``model.unit`` cycles among them), the
    share the program's spans hold."""
    by_name = defaultdict(list)
    for s in program:
        by_name[s.name].append((s.end_ns - s.start_ns) / 1e9)
    out = {"spans": {n: {"n": len(d), "mean_ms": 1e3 * sum(d) / len(d), "total_s": sum(d)}
                     for n, d in sorted(by_name.items())},
           "counters": dict(counters)}
    step = sum(t1 - t0 for n, t0, t1 in harness_spans if n == "train_step")
    if step > 0:
        out["phases_of_train_step"] = sum(sum(by_name[n]) for n in PHASES) / step
    replays, eager = counters.get("train.graph_replays", 0), counters.get("train.eager_steps", 0)
    if replays + eager > 0:
        out["replay_share"] = replays / (replays + eager)
    between = [(t0, t1) for n, t0, t1 in harness_spans if n == "eval.between"]
    if between:
        parts = defaultdict(float)
        for s in program:
            t = s.start_ns / 1e9
            if s.name in BETWEEN and any(t0 <= t < t1 for t0, t1 in between):
                parts[s.name] += (s.end_ns - s.start_ns) / 1e9
        total = sum(t1 - t0 for t0, t1 in between)
        out["between"] = {"total_s": total, "n": len(between), **{n: parts[n] for n in BETWEEN},
                          "share": sum(parts.values()) / total}
    copies = sum(d for n, _, d in kernels if "Memcpy HtoD" in n)
    if copies > 0 and counters.get("prefetch.bytes"):
        out["h2d_gbps"] = counters["prefetch.bytes"] / copies / 1e9
    train_labels = set(PHASES) | {"optimizer.clip", "optimizer.adam", "model.unit"}
    held = sum(s for label, s in idle_gaps if label in train_labels)
    left = sum(s for label, s in idle_gaps if label == "train_step")
    if held + left > 0:
        out["idle_in_program"] = held / (held + left)
    return out


class ProgramSpans(Recorder):
    """The harness's ``Recorder``, with the port's tracer on over the
    traced window and its spans in the result."""

    last = None  # the instance of the run, for ``main``

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.thread = None
        self.program, self.program_counters, self.readings = [], {}, {}
        ProgramSpans.last = self

    def _start(self) -> None:
        super()._start()
        trace.spans(), trace.counters()  # nothing from before the window
        self.thread = threading.get_ident()
        trace.enable()

    def _stop(self) -> None:
        trace.disable()
        self.program, self.program_counters = trace.spans(), trace.counters()
        super()._stop()

    def data(self, kind: str, config: dict, workload: dict):
        own, events = self._spans, harness_trace.device_events
        names, dropped = {s.name for s in self.program}, []

        def card_work(prof, chrome=False):
            """The card's operations without the spans' own ranges, which a
            profile may show on the card's timeline as annotations."""
            out = events(prof, chrome)
            dropped.extend(e for e in out if e[0] in names)
            return [e for e in out if e[0] not in names]

        self._spans = with_program(own, self.program, self.thread)
        harness_trace.device_events = card_work
        try:
            out = super().data(kind, config, workload)
        finally:
            self._spans, harness_trace.device_events = own, events
        for s in self.program:
            if s.thread != self.thread:
                out.spans[s.name].append((s.end_ns - s.start_ns) / 1e9)
        out.counters["program"] = dict(self.program_counters)
        gaps = (out.breakdown or {}).get("idle_gaps", [])
        self.readings = readings(own, self.program, self.program_counters, out.kernels, gaps)
        self.readings["idle_gaps"] = gaps
        self.readings["window_s"], self.readings["busy_s"] = out.window_s, out.busy_s
        self.readings["annotations_dropped"] = len(dropped)
        return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "program_spans"))
    args = p.parse_args(argv)
    from perfbench.lib.runner import main as run_cell
    from perfbench.run import PROCESS_START

    harness.Recorder = ProgramSpans  # what the run's Context builds
    rc = run_cell(["--workload", args.workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
                   "--trace", "1"], PROCESS_START)
    rec = ProgramSpans.last
    if rc == 0 and rec is not None:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.workload}.{args.seed}.json"), "w") as fh:
            json.dump(rec.readings, fh, indent=1)
        print("program spans: " + json.dumps(rec.readings), file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
