"""The port's ER examples (``examples/torch_*.py``) beside their JAX
examples on the CPU: each torch example's ``main(["--device", "cpu"])``
prints what its JAX example prints, line for line, once the clocks are
stripped (and the service's line about what its counter counts, which
names the port's builds instead of XLA compilations); the counts it
returns are the ones printed. Without a card the examples raise."""
import contextlib
import io
import re
import runpy
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402
from torch_parity import load_example  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
ER = ("quickstart", "dedup_sorted_neighborhood", "dedup_two_sources",
      "match_service", "chaos_drill")
# Clocks, and the two wordings of the service's counter.
STRIP = ((re.compile(r"modeled-makespan=[0-9.]+s"), "modeled-makespan=T"),
         (re.compile(r"[0-9,]+ ms$"), "T ms"),
         (re.compile(r"[0-9,]+ queries/s"), "Q queries/s"),
         (re.compile(r"^warmup .*"), "warmup W"),
         (re.compile(r"steady-state (recompiles|builds)"), "steady-state N"))
_RUNS = {}


def _normalized(text):
    lines = []
    for line in text.splitlines():
        for pat, rep in STRIP:
            line = pat.sub(rep, line)
        lines.append(line)
    return lines


def runs(name):
    """(the JAX example's stdout, the torch example's stdout, its dict),
    each example run once per test process."""
    if name not in _RUNS:
        jax_out = io.StringIO()
        with contextlib.redirect_stdout(jax_out):
            runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
        port_out = io.StringIO()
        with contextlib.redirect_stdout(port_out):
            got = load_example(name).main(["--device", "cpu"])
        _RUNS[name] = (jax_out.getvalue(), port_out.getvalue(), got)
    return _RUNS[name]


@pytest.mark.parametrize("name", ER)
def test_prints_what_the_jax_example_prints(name):
    want, got, _ = runs(name)
    assert _normalized(got) == _normalized(want)


def _ints(pattern, text):
    return [int(x.replace(",", "")) for x in re.findall(pattern, text)]


def test_quickstart_counts():
    want, _, got = runs("quickstart")
    rows = got["strategies"]
    assert list(rows) == ["basic", "block_split", "pair_range"]
    assert [r["pairs"] for r in rows.values()] == _ints(
        r"pairs=\s*([\d,]+)", want)
    assert [r["matches"] for r in rows.values()] == _ints(
        r"matches=\s*(\d+)", want)
    assert [r["map_output"] for r in rows.values()] == _ints(
        r"map-output=(\d+)", want)
    assert [f"{r['recall']:.3f}" for r in rows.values()] == re.findall(
        r"recall=([\d.]+)", want)
    assert len({r["matches"] for r in rows.values()}) == 1


def test_sorted_neighborhood_counts():
    want, _, got = runs("dedup_sorted_neighborhood")
    w = got["windows"]
    assert list(w) == [5, 10, 50]
    assert [r["pairs"] for r in w.values()] == _ints(
        r"band pairs=\s*([\d,]+)", want)
    assert [r["matches"] for r in w.values()] == _ints(
        r"matches=\s*(\d+)", want)
    assert got["baseline"]["pairs"] == _ints(
        r"baseline: ([\d,]+) pairs", want)[0]


def test_two_sources_counts():
    want, _, got = runs("dedup_two_sources")
    assert got["cross_pairs"] == _ints(r"cross pairs=([\d,]+)", want)[0]
    assert len(got["matches"]) == _ints(r"cross-source matches: (\d+)",
                                        want)[0]
    assert [list(m) for m in got["matches"][:5]] == [
        [int(a), int(b)] for a, b in re.findall(r"A\[(\d+)\].*B\[(\d+)\]",
                                                want)]


def test_match_service_counts():
    want, got_out, got = runs("match_service")
    assert [m for _, m in got["batches"]] == _ints(r"→\s*(\d+) matches",
                                                   want)
    assert got["matches"] == _ints(r"queries in \d+ batches, (\d+) matches",
                                   want)[0]
    assert got["steady_builds"] == 0 == _ints(
        r"(\d+) steady-state recompiles", want)[0]
    assert "XLA" not in got_out
    assert "kernel libraries" in got_out


def test_chaos_drill_counts():
    want, _, got = runs("chaos_drill")
    def printed(pattern):
        return tuple(int(x) for x in re.search(pattern, want).groups())

    assert (got["tiles"], got["survivors"]) == printed(
        r"quiet run: (\d+) tiles, (\d+) survivors")
    assert (got["rounds"], got["failed_shards"],
            got["recovered_tiles"]) == printed(
        r"recovered in (\d+) rounds: (\d+) failed shards .*?, (\d+) "
        r"tiles re-executed")
    assert got["coverage"] == 1.0 and got["degraded"] == 0
    assert (got["evictions"], got["readmissions"], got["request_retries"],
            got["service_recovered_tiles"]) == printed(
        r"(\d+) evictions, (\d+) readmissions; (\d+) request retries, "
        r"(\d+) tiles recovered")


@pytest.mark.parametrize("name", ER)
def test_the_card_is_the_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example(name).main([])
