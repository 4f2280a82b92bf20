"""Nothing the harness imports is JAX or the JAX package, and the
references import nothing of the port; compared by whole top-level
module names (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "tgp_tpu"}
FILES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    got = top_level_imports(path)
    assert not got & (BANNED | {"tgp_tpu_torch"})
    assert got <= {"__future__", "math", "numpy", "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "portbench"):
            assert node.module.startswith("portbench.reference")


def test_a_run_loads_no_jax():
    """A whole run on the CPU at a tiny size, then the loaded modules."""
    code = f"""
import sys, time
sys.path[:0] = [{str(HERE.parent)!r}, {str(HERE)!r}]
import run
from portbench.harness import spec
cell = spec.load_cell("serve-large-graph")
cell.traffic.update(nodes={{"dist": "fixed", "value": 256}},
                    edges={{"kind": "uniform_directed", "count": 2000}},
                    check_requests=2)
run.run_cell(cell, 3, 0.2, False, "cpu", time.perf_counter())
print(sorted(run.banned_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
