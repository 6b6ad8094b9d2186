"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program. Top-level module names are compared whole:
``repro_torch`` is the port, ``repro`` the JAX package."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*skip):
    return [p for p in BENCH.rglob("*.py")
            if not any(part in skip for part in p.relative_to(BENCH).parts)]


@pytest.mark.parametrize("path", _sources("tests"), ids=lambda p: p.name)
def test_no_jax_import_in_harness(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.er.service", "numpy"], []),
    (["repro.er.pipeline", "jaxlib.xla_client", "torch"], ["jaxlib", "repro"]),
    (["jax", "flax.linen"], ["flax", "jax"]),
])
def test_names_are_compared_whole(names, found):
    from erbench.run import forbidden_modules
    assert forbidden_modules(names) == found


def test_a_run_loads_no_jax():
    """A whole small run in a fresh process: afterwards ``sys.modules``
    holds no forbidden top-level name."""
    code = (
        "import sys, json, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from erbench.tests.helpers import run_small\n"
        "from erbench.run import forbidden_modules\n"
        "out = run_small('ds1_products.batch_pair_range', seconds=0.5)\n"
        "print(json.dumps([out['correct'], forbidden_modules(),\n"
        "    sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch'})]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    correct, bad, port = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and port == ["repro_torch"]
