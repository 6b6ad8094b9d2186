"""The port's tables and runner (group f): ``torch_roofline_table``
renders the same markdown rows as the JAX ``roofline_table`` for the
same dry-run rows (ok, skip and fail), the JAX module run unchanged from
a copy beside its rows under ``tmp_path``; ``torch_run`` runs the torch
legs under the JAX runner's suite names and summarises the port's
dry-run tables."""
import importlib.util
import json
import re
import shutil
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ok(arch, shape, scale):
    return {"arch": arch, "shape": shape, "mesh": "16x16", "chips": 256,
            "flops/dev": 1e15 * scale, "bytes/dev": 2e12 * scale,
            "coll_wire_bytes/dev": 3e9 * scale, "coll_ops": 7,
            "compute_s": 0.0123 * scale, "memory_s": 1.5 * scale,
            "collective_s": 0.25 * scale, "bottleneck": "memory",
            "step_s": 1.5 * scale, "useful_flops_frac": 0.8123,
            "mfu": 0.04567, "arg_bytes/dev": 1 << 30,
            "temp_bytes/dev": 3 << 30, "count_s": 1.2, "status": "ok",
            "temp_bytes_gib": 3.0, "arg_bytes_gib": 1.0}


ROWS = [_ok("qwen3-4b", "train_4k", 1.0), _ok("qwen3-4b", "decode_32k", 1e-3),
        {"arch": "llama3.2-3b", "shape": "long_500k", "mesh": "16x16",
         "status": "skip", "reason": "full attention"},
        _ok("smollm-360m", "prefill_32k", 0.5),
        {"arch": "zamba2-2.7b", "shape": "train_4k", "mesh": "16x16",
         "status": "fail", "error": "boom"}]


def _jax_render(tmp_path, rows, mesh="16x16"):
    """The JAX ``render`` from an unchanged copy under ``tmp_path``, its
    rows beside it in ``tmp_path/out`` (nothing under benchmarks/out)."""
    shutil.copy(ROOT / "benchmarks" / "roofline_table.py",
                tmp_path / "roofline_table.py")
    (tmp_path / "out").mkdir(exist_ok=True)
    (tmp_path / "out" / f"dryrun_{mesh}.json").write_text(json.dumps(rows))
    spec = importlib.util.spec_from_file_location(
        "roofline_table_copy", tmp_path / "roofline_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.render(mesh)


def _table_rows(text):
    return [line for line in text.splitlines() if line.startswith("|")]


@pytest.mark.parametrize("keep", ["all", "ok", "skip", "fail"])
def test_roofline_rows_equal_the_jax_table(keep, monkeypatch, tmp_path):
    _, torch_roofline_table = tp.bench_legs("roofline_table", monkeypatch,
                                            tmp_path)
    rows = [r for r in ROWS if keep == "all" or r["status"] == keep]
    want = _jax_render(tmp_path, rows)
    path = tmp_path / "torch_rows.json"
    path.write_text(json.dumps(rows))
    got = torch_roofline_table.render("16x16", path=str(path))
    assert _table_rows(got) == _table_rows(want)
    assert len(_table_rows(got)) == 2 + len(rows)
    heading = got.splitlines()[0]
    assert "H100" in heading and "989 TFLOP/s" in heading
    assert "3.35 TB/s" in heading


def test_roofline_reads_the_ports_dryrun_by_default(monkeypatch, tmp_path):
    _, torch_roofline_table = tp.bench_legs("roofline_table", monkeypatch,
                                            tmp_path)

    with pytest.raises(FileNotFoundError, match=r"out/torch_dryrun_nomesh"):
        torch_roofline_table.render("nomesh")


def test_run_quick_on_the_cpu(monkeypatch, tmp_path, capsys):
    _, torch_run = tp.bench_legs("run", monkeypatch, tmp_path)

    assert torch_run.main(["--quick", "--only", "fig8,fig12,schedule",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.findall(r"######## (\w+) ########", out) == [
        "fig8", "fig12", "schedule"]
    for name in ("fig8_datasets", "fig12_map_output", "schedule_bench"):
        assert (tmp_path / f"torch_{name}.json").exists()


def test_run_has_the_jax_runners_suites(monkeypatch, tmp_path):
    _, torch_run = tp.bench_legs("run", monkeypatch, tmp_path)

    jax_suites = re.findall(r'^\s+"(\w+)": lambda',
                            (ROOT / "benchmarks" / "run.py").read_text(),
                            re.M)
    assert list(torch_run.SUITES) == jax_suites
    assert set(torch_run._legs()) == set(jax_suites)


def test_run_refuses_an_unknown_suite(monkeypatch, tmp_path, capsys):
    _, torch_run = tp.bench_legs("run", monkeypatch, tmp_path)

    with pytest.raises(SystemExit) as e:
        torch_run.main(["--only", "fig99", "--device", "cpu"])
    assert e.value.code == 2
    assert "fig99" in capsys.readouterr().err


def test_run_summarises_the_ports_dryrun_tables(monkeypatch, tmp_path):
    _, torch_run = tp.bench_legs("run", monkeypatch, tmp_path)
    (tmp_path / "torch_dryrun_16x16.json").write_text(json.dumps(ROWS))
    (tmp_path / "dryrun_2x16x16.json").write_text(json.dumps(ROWS))
    assert torch_run.dryrun_summary(str(tmp_path)) == [
        f"dry-run 16x16: 3 ok / 1 skip / 1 fail "
        f"({tmp_path / 'torch_dryrun_16x16.json'})"]
    assert "repro_torch.launch.dryrun" in torch_run.__doc__
