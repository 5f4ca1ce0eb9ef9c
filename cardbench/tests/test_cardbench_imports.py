"""What the benchmark's modules import, compared by whole top-level name:
``repro_torch`` begins with ``repro``, and is the program under test."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
MODULES = sorted(p for p in (ROOT / "cardbench").rglob("*.py")
                 if "tests" not in p.relative_to(ROOT / "cardbench").parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", MODULES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((ROOT / "cardbench" / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = set(_imports(path))
    assert tops <= {"__future__", "numpy", "torch"}, tops
    src = path.read_text()
    assert "from ." not in src and "from .." not in src


def test_the_top_level_name_is_compared_whole():
    from cardbench import run
    saved = dict(sys.modules)
    try:
        sys.modules.setdefault("repro_torch", saved.get("repro_torch")
                               or type(sys)("repro_torch"))
        sys.modules.pop("repro", None)
        assert "repro" not in run.forbidden_modules()
        sys.modules["repro"] = type(sys)("repro")
        assert "repro" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_leaves_jax_out_of_the_process():
    """A whole tiny run on the CPU in a process of its own: the program
    and the harness load neither JAX nor the JAX package."""
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "import torch; torch.set_num_threads(1)\n"
        "from cardbench import run\n"
        "from cardbench.tests.conftest import tiny\n"
        "man = run.manifest()\n"
        "for cell in [w['name'] for w in man['workloads']\n"
        "             if w['chips'] == 1]:\n"
        "    cfg, tf = tiny(man, cell)\n"
        "    line, _ = run.run_cell(man, cell, 7, 0.5, True, device='cpu',\n"
        "                           config=cfg, traffic=tf)\n"
        "    assert line['correct'], line\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'jax', 'jaxlib', 'flax', 'repro'}))\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.strip().splitlines()[-1] == "[]"
