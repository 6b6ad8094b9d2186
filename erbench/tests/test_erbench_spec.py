"""BENCHMARK.json keeps to the contract's names, units and structure, and
every name it uses has its file."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [w["name"] for w in SPEC["workloads"]]
                         + [c["name"] for c in SPEC["configs"]]
                         + [w["traffic"] for w in SPEC["workloads"]])
def test_names(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (ROOT / "erbench" / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moves = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    conf = {c["name"]: c for c in SPEC["configs"]}[cell["config"]]
    assert (ROOT / conf["file"]).exists()
    assert json.loads((ROOT / conf["file"]).read_text())["reduced"] == \
        conf["reduced"]
    assert (ROOT / "erbench" / "traffic" / f"{cell['traffic']}.json").exists()
    assert (ROOT / "erbench" / "limits" / f"{cell['name']}.json").exists()
    assert cell["chips"] == 1 and 1 <= len(cell["why"]) <= 200

    def reports(kind):
        return [m["name"] for m in SPEC[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]
    e2e = reports("end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reports("per_layer")


def test_command_stays_inside_paths():
    assert SPEC["command"] == ["python3", "erbench/run.py"]
    assert SPEC["paths"] == ["erbench"]
