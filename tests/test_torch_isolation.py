"""The port stands alone: no module of ``src/repro_torch``, no torch leg
of the benchmarks (``benchmarks/torch_*.py``), no torch example
(``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX or the
JAX package ``repro`` (an AST walk, so imports inside functions count
too); the completeness test, which parses both trees, imports neither
package nor JAX nor torch; a torch leg or example imports no JAX leg (of ``benchmarks/`` only
``common`` and the other ``torch_*`` modules, relative or not) and no
JAX example; and importing the port, its legs or its examples pulls
neither into the process."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LEGS = sorted((ROOT / "benchmarks").glob("torch_*.py"))
EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))
JAX_EXAMPLES = {p.stem for p in (ROOT / "examples").glob("*.py")
                if not p.stem.startswith("torch_")}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + LEGS + \
    EXAMPLES + [ROOT / "chip_smoke.py"]
PARSE_ONLY = [ROOT / "tests" / "test_torch_completeness.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _benchmark_imports(tree):
    """The modules of ``benchmarks/`` that ``tree`` imports: relative
    imports (``from .x import y``, ``from . import x``) and absolute
    ``benchmarks.x`` ones."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            parts = (node.module or "").split(".")
            if node.level == 0 and parts[0] != "benchmarks":
                continue
            if node.level == 0:
                parts = parts[1:]
            if parts and parts[0]:
                yield parts[0]
            else:
                yield from (a.name for a in node.names)
        elif isinstance(node, ast.Import):
            for a in node.names:
                parts = a.name.split(".")
                if parts[0] == "benchmarks" and len(parts) > 1:
                    yield parts[1]


def _bad_benchmark_imports(source: str):
    return [m for m in _benchmark_imports(ast.parse(source))
            if m != "common" and not m.startswith("torch_")]


def test_a_jax_leg_import_is_caught():
    assert _bad_benchmark_imports(
        "from .serve_bench import skewed_corpus") == ["serve_bench"]
    assert _bad_benchmark_imports("from . import chaos_bench") == [
        "chaos_bench"]
    assert _bad_benchmark_imports(
        "def f():\n    import benchmarks.fig9_skew") == ["fig9_skew"]
    assert _bad_benchmark_imports(
        "from .common import timer\nfrom .torch_serve_bench import x\n"
        "from benchmarks import torch_common") == []


@pytest.mark.parametrize("path", LEGS + EXAMPLES, ids=lambda p: p.name)
def test_legs_import_no_jax_leg(path):
    bad = _bad_benchmark_imports(path.read_text())
    assert not bad, f"{path.name} imports the JAX legs {bad}"


def test_the_seven_torch_examples_exist():
    assert {p.stem for p in EXAMPLES} == {f"torch_{n}" for n in JAX_EXAMPLES}
    assert len(EXAMPLES) == 7


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_examples_import_no_jax_example(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[-1] in JAX_EXAMPLES
           or n.split(".")[0] == "examples"]
    assert not bad, f"{path.name} imports the JAX examples {bad}"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", PARSE_ONLY, ids=lambda p: p.name)
def test_parse_only_tests_import_no_package(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in
           ("jax", "jaxlib", "repro", "repro_torch", "torch")]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.er, repro_torch.er.service, "
            "repro_torch.er.batcher, repro_torch.er.distributed, "
            "repro_torch.sharding, repro_torch.kernels, "
            "repro_torch.convert, repro_torch.configs, repro_torch.models, "
            "repro_torch.serve, repro_torch.train, "
            "repro_torch.train.checkpoint, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.configs.shapes, "
            "repro_torch.launch.mesh, repro_torch.launch.steps, "
            "repro_torch.launch.roofline, repro_torch.launch.dryrun, "
            "repro_torch.launch.inspect_cell, "
            + ", ".join(f"benchmarks.{p.stem}" for p in LEGS) + "; "
            "import importlib.util as u; "
            + "; ".join(f"s = u.spec_from_file_location('{p.stem}', "
                        f"'{p}'); s.loader.exec_module(u.module_from_spec(s))"
                        for p in EXAMPLES) + "; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(
                             ROOT / "src") + os.pathsep + str(ROOT)})
    assert out.stdout.strip() == "[]"
