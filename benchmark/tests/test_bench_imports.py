"""What runs on the chip loads no JAX and no JAX package, judged by whole
top-level module names; the reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from benchmark import harness


def test_check_compares_whole_top_level_names():
    assert harness.banned_modules({"diffdrr_tpu_torch", "diffdrr_tpu_torch.drr", "jaxtyping",
                                   "flaxen", "torch"}) == []
    assert harness.banned_modules({"diffdrr_tpu.ops.siddon", "jax.numpy", "jaxlib", "flax"}) == [
        "diffdrr_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p for p in harness.HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(harness.BANNED), tops
    if "reference" in path.parts or "yardstick" in path.parts:
        assert "diffdrr_tpu_torch" not in tops


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "from benchmark.tests.tiny import tiny_cell\n"
            "harness.run_cell(tiny_cell('render-b32-chest133-siddon'), 3, 0.1, False, "
            "device='cpu', log=lambda m: None)\n"
            "print(harness.banned_modules())\n") % str(harness.REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
