"""A cell, a configuration, a per-layer metric and a kernel's work count
are found by their names: adding one is adding files and entries."""

import json
import shutil
import tempfile
import textwrap
from pathlib import Path

from perfbench.lib import common
from perfbench.lib.runner import metrics_of
from perfbench.lib.trace import TraceData


def test_new_files_are_found_by_name():
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        shutil.copytree(common.BENCH, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(common.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
        bench = root / "perfbench"
        config = common.config("msvd-qa")
        config["name"] = "msvd-qa-wide"
        (bench / "configs" / "msvd-qa-wide.json").write_text(json.dumps(config))
        cell = dict(common.workload("msvd-qa.eval"), config="msvd-qa-wide")
        (bench / "workloads" / "msvd-qa-wide.eval.json").write_text(json.dumps(cell))
        (bench / "roofline" / "k9_probe.py").write_text(textwrap.dedent('''
            import re
            PATTERN = re.compile("probe_kernel")
            def launches(step, model):
                return [(165e9, 0.0)]
        '''))
        (bench / "metrics" / "k9_probe_roofline.eval.py").write_text(textwrap.dedent('''
            import importlib.util, pathlib
            spec = importlib.util.spec_from_file_location(
                "k9_probe", pathlib.Path(__file__).parent.parent / "roofline" / "k9_probe.py")
            k9_probe = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(k9_probe)
            from perfbench.lib.roofline import share
            def read(trace):
                return share(trace, k9_probe)
        '''))
        manifest = common.manifest(root)
        manifest["workloads"].append({"name": "msvd-qa-wide.eval", "config": "msvd-qa-wide", "traffic": "eval",
                                      "chips": 1, "why": "a test"})
        manifest["per_layer"].append({"name": "k9_probe_roofline.eval", "unit": "%", "better": "higher",
                                      "source": "device_trace", "layer": "Kernel 9", "moves": "eval_qa_per_s",
                                      "workloads": ["msvd-qa-wide.eval"]})
        (root / "BENCHMARK.json").write_text(json.dumps(manifest))

        manifest = common.manifest(root)
        assert common.workload("msvd-qa-wide.eval", bench)["config"] == "msvd-qa-wide"
        assert common.config("msvd-qa-wide", bench)["model"]["num_of_nodes"] == 8
        names = [m["name"] for m in metrics_of(manifest, "msvd-qa-wide.eval", "per_layer")]
        assert names == ["k9_probe_roofline.eval"]
        trace = TraceData("eval", config, cell, window_s=1.0, kernels=[("probe_kernel", 0.0, 2e-3)],
                          steps=[{"rows": 1}])
        assert abs(common.reader("k9_probe_roofline.eval", bench)(trace) - 50.0) < 1e-9
