"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro`` (an AST walk,
so imports inside functions count too), and importing the port pulls
neither into the process."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    names = list(_imported(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")]
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
            "repro_torch.launch.inspect_cell; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "[]"
