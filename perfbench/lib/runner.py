"""One run of one cell: set-up, the measured window, the comparison, and
the result's line."""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import tempfile

from perfbench.lib import common
from perfbench.lib.harness import Context


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_entry(manifest: dict, cell: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == cell:
            return w
    raise SystemExit(f"BENCHMARK.json has no cell {cell!r}")


def metrics_of(manifest: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end-to-end (``kind`` "end_to_end") or per-layer metrics."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(ctx: Context) -> dict:
    driver = importlib.import_module(f"perfbench.drivers.{ctx.workload['driver']}")
    return driver.run(ctx)


def main(argv, process_start: float) -> int:
    args = parse(argv)
    manifest = common.manifest()
    entry = cell_entry(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"the cell needs {entry['chips']} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # fp32 as the configurations state it: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload = common.workload(args.workload)
    config = common.config(workload["config"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        ctx = Context(args.workload, workload, config, args.seed, args.seconds, bool(args.trace), device, tmp)
        res = run_cell(ctx)
    loaded = common.forbidden_modules(sys.modules)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port alone", file=sys.stderr)
        return 3

    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": entry["chips"],
                   "memory_peak_bytes": res["memory_peak_bytes"], "power_limit_w": power_limit_w()}
    out = {"correct": all(c["ok"] for c in res["checks"]) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"], "metrics": {}, "device": device_info}
    if args.trace:
        trace = ctx.rec.data(workload["driver"], config, workload)
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        ctx.log.extend(trace.notes)
        for m in metrics_of(manifest, args.workload, "per_layer"):
            value = common.reader(m["name"])(trace)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        if trace.breakdown is not None:
            out["breakdown"] = trace.breakdown
    else:
        values = dict(res["e2e"], setup_s=res["window"][0] - process_start)
        for m in metrics_of(manifest, args.workload, "end_to_end"):
            out["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in res["checks"]}
    at = process_start
    for name, t in ctx.stages:
        print(f"set-up: {name} {t - at:.3f} s", file=sys.stderr)
        at = t
    for line in ctx.log:
        print(line, file=sys.stderr)
    print("readings: " + json.dumps(ctx.readings), file=sys.stderr)
    for c in res["checks"]:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
