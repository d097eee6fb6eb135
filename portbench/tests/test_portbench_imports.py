"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: soda_tpu_torch begins with soda_tpu), and the references import
nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

from conftest import CHECKOUT

PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from portbench import control, harness, loop, run
bench = harness.load_benchmark()
for name, devs, grid in (("jacobi3d-512.loop", ["cpu"], (12, 8, 10)),
                         ("jacobi3d-2048.mesh-loop", ["cpu"] * 4, (12, 8, 10)),
                         ("jacobi2d-16384.loop", ["cpu"], (40, 24))):
    for trace in (False, True):
        cell = loop.Cell(bench, name, grid=grid, devices=devs)
        got = loop.run(cell, 1, 0.02, trace, 0.0, lambda *a: None)
        run.result(bench, cell, got, trace)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE, str(CHECKOUT)], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    top = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "soda_tpu_torch" in top and "torch" in top
    assert not top & set(harness.BANNED), top & set(harness.BANNED)


def test_banned_names_compared_whole():
    assert harness.banned_modules({"soda_tpu_torch": 1, "soda_tpu_torch.entry": 1,
                                   "jaxtyping": 1}) == []
    assert harness.banned_modules({"soda_tpu.backend": 1, "jax": 1, "flax.linen": 1}) == [
        "flax.linen", "jax", "soda_tpu.backend"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in (CHECKOUT / "portbench").rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(CHECKOUT)))
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & set(harness.BANNED)


@pytest.mark.parametrize("path", sorted((CHECKOUT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "math", "numpy", "torch"}
