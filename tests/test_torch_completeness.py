"""The port is complete: every module of the JAX package ``src/repro`` has
a twin at the same relative path under ``src/repro_torch``, and every
public module-level ``def``, ``class`` and UPPER-CASE constant of a
module is bound in its twin under the same name, or stands in ``RENAMED``
with its counterpart and a reason. Both trees are parsed with ``ast``;
neither package is imported."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# (module, reference name) -> ((module, port name) or None, reason)
RENAMED = {
    ("core/assignment.py", "greedy_lpt_jnp"):
        (("core/assignment.py", "greedy_lpt_torch"), "the jnp twin in torch"),
    ("core/bdm.py", "compute_bdm_jnp"):
        (("core/bdm.py", "compute_bdm_torch"), "the jnp twin in torch"),
    ("core/bdm.py", "entity_indices_jnp"):
        (("core/bdm.py", "entity_indices_torch"), "the jnp twin in torch"),
    ("core/bdm.py", "jax_cummax"):
        (None, "a cummax for old jax; the port calls torch.cummax"),
    ("core/pair_range.py", "pairs_of_range_jnp"):
        (("core/pair_range.py", "pairs_of_range_torch"),
         "the jnp twin in torch"),
    ("kernels/grouped_mm.py", "pltpu_prefetch"):
        (None, "TPU scalar prefetch; the CUDA kernel reads its tile table "
               "from global memory"),
    ("kernels/pair_sim.py", "VMEM_BUDGET_BYTES"):
        (("kernels/pair_sim.py", "SMEM_BUDGET_BYTES"),
         "a TPU's VMEM is a CUDA block's shared memory"),
    ("kernels/pair_sim.py", "catalog_vmem_bytes"):
        (("kernels/pair_sim.py", "catalog_smem_bytes"),
         "a TPU's VMEM is a CUDA block's shared memory"),
    ("kernels/pair_sim.py", "check_vmem"):
        (("kernels/pair_sim.py", "check_smem"),
         "a TPU's VMEM is a CUDA block's shared memory"),
    ("launch/roofline.py", "analyze_compiled"):
        (("launch/roofline.py", "analyze_cell"),
         "the port counts an eager step; nothing is compiled"),
    ("launch/roofline.py", "scan_hidden_flops"):
        (None, "XLA's cost analysis counts a scan body once; the port's "
               "count runs every layer"),
    ("models/layers.py", "stack_layers"):
        (("models/transformer.py", "Stack"),
         "the port holds one parameter node per layer"),
}

MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _assigned(node):
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                yield n.id


def public_names(path: Path) -> set:
    """Module-level defs and classes not starting with ``_``, and
    UPPER-CASE constants."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            if not node.name.startswith("_"):
                names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= {n for n in _assigned(node)
                      if n.isupper() and not n.startswith("_")}
    return names


def bound_names(path: Path) -> set:
    """Every name bound at module level: defs, classes, assignments and
    imports (a twin may re-export)."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names |= set(_assigned(node))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def test_every_module_has_a_twin():
    assert len(MODULES) > 50
    missing = [m for m in MODULES if not (PORT / m).is_file()]
    assert not missing, f"no twin under src/repro_torch: {missing}"


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    twin = bound_names(PORT / module)
    for name in sorted(public_names(REF / module)):
        if name in twin:
            assert (module, name) not in RENAMED, (
                f"{module}: {name} is ported under its name; drop it from "
                "RENAMED")
            continue
        assert (module, name) in RENAMED, (
            f"{module}: {name} has no counterpart in the twin")
        target, reason = RENAMED[module, name]
        assert reason
        if target is not None:
            assert target[1] in bound_names(PORT / target[0]), target


def test_renamed_entries_name_reference_names():
    for (module, name) in RENAMED:
        assert name in public_names(REF / module), (module, name)
