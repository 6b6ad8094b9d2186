"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries alone, and the harness runs them: no existing file of
the benchmark changes."""
import hashlib
import json
import shutil
import time
from pathlib import Path

from erbench.harness import Layout, make_cell, run_cell

ROOT = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "metrics", "limits")


def _digest():
    files = [ROOT / "BENCHMARK.json"] + sorted(
        p for d in DATA for p in (ROOT / "erbench" / d).iterdir())
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def test_new_config_mix_and_metric_from_files(tmp_path):
    before = _digest()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in DATA:
        shutil.copytree(ROOT / "erbench" / d, tmp_path / "erbench" / d)
    bench = tmp_path / "erbench"
    conf = json.loads((bench / "configs" / "ds1_products.json").read_text())
    conf["name"] = "tiny_products"
    conf["data"]["n"] = 2500
    (bench / "configs" / "tiny_products.json").write_text(json.dumps(conf))
    (bench / "traffic" / "batch_basic.json").write_text(json.dumps(
        {"driver": "batch", "run_er": {"strategy": "basic"}}))
    (bench / "metrics" / "runs_in_window.py").write_text(
        "def read(record):\n    return float(len(record['runs']))\n")
    (bench / "limits" / "tiny_products.batch_basic.json").write_text(
        json.dumps({"limits": {"survivor_diff": 0, "match_diff": 0,
                               "failed": 0}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = "tiny_products.batch_basic"
    spec["configs"].append({"name": "tiny_products", "source": "test",
                            "file": "erbench/configs/tiny_products.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": cell, "config": "tiny_products",
                              "traffic": "batch_basic", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "batch_entities_per_s":
            m["workloads"].append(cell)
    spec["per_layer"].append({"name": "runs_in_window", "unit": "runs",
                              "better": "higher", "source": "host_clock",
                              "layer": "pipeline",
                              "moves": "batch_entities_per_s",
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    layout = Layout(tmp_path)
    for trace in (False, True):
        c = make_cell(layout, cell, 77, 0.5, trace, "cpu")
        out = run_cell(c, time.perf_counter(), layout)
        assert out["correct"], out["check"]
        names = set(out["metrics"])
        if trace:
            assert out["metrics"]["runs_in_window"]["value"] >= 1
            assert names == {"runs_in_window"}
        else:
            assert names == {"batch_entities_per_s", "setup_s"}
    assert _digest() == before
