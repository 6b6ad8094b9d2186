"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file, ``erbench/traffic/<traffic>.json`` (which names a
driver, ``erbench/drivers/<driver>.py``), ``erbench/metrics/<metric>.py``
for each metric, and ``erbench/limits/<cell>.json`` (the limits of the
check, and how much of the window it reads: ``check_pairs``). A new cell, mix or
metric is a new file and a new entry; no existing file changes.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check
from .trace import Trace

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Layout:
    """Where the benchmark's files are: ``root`` holds ``BENCHMARK.json``
    and the ``erbench/`` directory of data files and metric readers."""
    root: Path = ROOT

    def spec(self) -> Dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def json(self, *parts: str) -> Dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def metric(self, name: str):
        path = self.root / "erbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"erbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int = 1
    metrics: List[Dict] = field(default_factory=list)
    limits: Dict = field(default_factory=dict)    # number -> limit
    check: Dict = field(default_factory=dict)     # how much the check reads


def _merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make_cell(layout: Layout, name: str, seed: int, seconds: float,
              trace: bool, device: str,
              overrides: Optional[Dict] = None) -> Cell:
    spec = layout.spec()
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _merge(layout.json(conf["file"]), (overrides or {}).get(
        "config", {}))
    traffic = _merge(layout.json("erbench", "traffic",
                                 f"{w['traffic']}.json"),
                     (overrides or {}).get("traffic", {}))
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in spec[kind] if _applies(m, name)]
    lim = layout.json("erbench", "limits", f"{name}.json")
    check = _merge({k: v for k, v in lim.items() if k != "limits"},
                   (overrides or {}).get("check", {}))
    return Cell(name=name, config=config, traffic=traffic, seed=int(seed),
                seconds=float(seconds), trace=bool(trace), device=device,
                chips=int(w["chips"]), metrics=metrics,
                limits=lim["limits"], check=check)


def device_info(device: str) -> Dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def run_cell(cell: Cell, t_start: float, layout: Layout = Layout()) -> Dict:
    """Set up, measure, check; returns the result object (keys in the
    order they are printed, ``check`` last)."""
    driver = importlib.import_module(
        f"erbench.drivers.{cell.traffic['driver']}")
    state = driver.setup(cell)
    setup_s = time.perf_counter() - t_start
    tracer = Trace(cell.trace)
    log = check.SurvivorLog()
    with check.record_survivors(log, driver.survivor_modules()):
        record = driver.window(state, cell, log, tracer,
                               tracer.spans.around(driver.span_targets(),
                                                  cell.trace))
    device = device_info(cell.device)
    record["setup_s"] = setup_s
    record["trace"] = tracer.summary()
    record["device_name"] = device["kind"]
    numbers = driver.judge(state, record, cell)
    del state
    gc.collect()
    correct, compared = check.verdict(numbers, cell.limits)
    metrics = {}
    for m in cell.metrics:
        value = layout.metric(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = (len(record["runs"]) if record["kind"] == "batch"
                 else len(record["requests"]))
    if record["trace"] is not None:
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["window_s"]
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": int(numbers["failed"]), "metrics": metrics,
           "device": device}
    if record["trace"] is not None:
        out["breakdown"] = record["trace"]["breakdown"]
    out["window"] = {"seconds": record["window_s"]}
    if record["kind"] == "batch":
        out["window"]["runs_s"] = [r.get("seconds") for r in record["runs"]]
    out["check"] = compared
    return out
