"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that serve it."""

import json
import re

import pytest

from perfbench.lib import common

MANIFEST = common.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def cells_reporting(metric: str) -> set:
    entry = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric)
    return set(entry.get("workloads", [w["name"] for w in MANIFEST["workloads"]]))


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16 and all(PATH.fullmatch(p) and ".." not in p for p in MANIFEST["paths"])
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)


def test_a_full_check_fits_its_time_at_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names), names


def test_configs_have_their_files():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/configs/")
        data = json.loads((common.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert sorted(c["reduced"]) == sorted(data["reduced"])
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_cells_have_their_files_and_one_chip():
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
        cell = common.workload(w["name"])
        assert cell["config"] == w["config"] and cell["driver"] == w["traffic"]
        assert (common.BENCH / "drivers" / f"{cell['driver']}.py").exists()


def test_end_to_end_metrics():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert {"train_qa_per_s", "eval_qa_per_s", "setup_s"} <= names
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in MANIFEST["workloads"]:
        reported = [m for m in MANIFEST["end_to_end"] if w["name"] in cells_reporting(m["name"])]
        assert any(m["name"] == "setup_s" for m in reported) and len(reported) >= 2


def test_per_layer_metrics_move_what_their_cells_report():
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.fullmatch(m["unit"]) and m["source"] in SOURCES and m["better"] in ("lower", "higher")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
        assert set(m["workloads"]) <= cells_reporting(m["moves"]), m["name"]
        assert (common.BENCH / "metrics" / f"{m['name']}.py").exists()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in MANIFEST["workloads"]:
        assert any(w["name"] in m["workloads"] for m in MANIFEST["per_layer"])


def test_kernel_rooflines_are_named_by_their_kernel():
    for m in MANIFEST["per_layer"]:
        if "roofline" in m["name"]:
            kernel = m["name"].split("_roofline")[0]
            assert (common.BENCH / "roofline" / f"{kernel}.py").exists()
