"""Rules the port keeps: it stands apart from the JAX package, runs on the
card unless asked for the CPU, and every kernel in its registry names the
TPU kernel it replaces and has a plain version beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "profile_frame.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


KERNEL_FILES = sorted((PORT / "kernels").rglob("*.py"))


def _absolute_imports(path):
    """Every module ``path`` imports, relative imports resolved against
    its package."""
    pkg = list(path.relative_to(ROOT / "src").with_suffix("").parts[:-1])
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            yield ".".join(base + ([node.module] if node.module else []))


@pytest.mark.parametrize("path", KERNEL_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernels_layer_imports_no_layer_above_it(path):
    """The kernels sit under the libraries and the NLINV modules that
    call them, and import neither."""
    for mod in _absolute_imports(path):
        assert not mod.startswith(("repro_torch.lib", "repro_torch.nlinv",
                                   "repro_torch.core")), (path, mod)


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.nlinv, repro_torch.convert,"
            " repro_torch.core.plan, repro_torch.lib.plan, "
            "repro_torch.lib.fft, repro_torch.lib.gridding, "
            "repro_torch.kernels.registry as r; r.specs(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_need_the_card_unless_asked(monkeypatch):
    from repro_torch.nlinv.operators import make_ops, uinit
    from repro_torch.nlinv.recon import Reconstructor
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Reconstructor()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        uinit(2, 4)
    import numpy as np
    with pytest.raises(RuntimeError):
        make_ops(np.ones((4, 4)), np.ones((4, 4)), np.ones((4, 4)))
    assert Reconstructor(device="cpu").device.type == "cpu"


def test_registry_holds_the_seven_kernels_of_the_main_path():
    """The frame's seven kernels, then the radial path's two."""
    names = [s.name for s in registry.specs()]
    assert names == ["coil_forward", "coil_lincomb", "coil_scale_mult",
                     "plane_mult", "coil_adjoint", "cg_update", "xpby",
                     "degrid", "grid_adjoint"]


@pytest.mark.parametrize("spec", registry.specs(), ids=lambda s: s.name)
def test_spec_names_its_tpu_kernel_and_plain_version(spec):
    path, line = spec.replaces.rsplit(":", 1)
    src = ROOT / path
    assert src.parent.parent == ROOT / "src" / "repro" / "kernels"
    assert src.name == "kernel.py"
    text = src.read_text().splitlines()
    assert text[int(line) - 1].startswith(f"def {spec.tpu_function}("), \
        (spec.replaces, spec.tpu_function)
    assert "pl.pallas_call(" in src.read_text()
    assert callable(spec.plain) and callable(spec.kernel)
    cu = ROOT / spec.source
    assert cu.suffix == ".cu" and f"int {spec.entry}(" in cu.read_text()
    assert spec.tpu_function in cu.read_text()
    assert spec.tol in (1e-5, 1e-4, 1e-3)


# The main path's byte budgets (J = 8 on the 768 x 768 grid): every input
# read once, every output written once.  coil_adjoint is called without a
# mask on the main path, so its budget has no mask plane.  The gridding
# rows are the gather form's bytes for frame 0's trajectory (11 spokes of
# 1536 samples): degrid reads the 19887 grid cells the samples touch, per
# coil, plus the taps and writes the samples; grid_adjoint reads the
# samples and the cell index and writes the whole grid.  The TPU form's
# dense matrices alone would be 103.8 MB.
BYTES_MB = {"coil_forward": 80.2, "coil_lincomb": 125.0,
            "coil_scale_mult": 82.6, "plane_mult": 77.9,
            "coil_adjoint": 80.2, "cg_update": 226.5, "xpby": 113.2,
            "degrid": 2.9, "grid_adjoint": 42.0}


@pytest.mark.parametrize("spec", registry.specs(), ids=lambda s: s.name)
def test_spec_bound_at_main_path_shapes(spec):
    args = spec.sample(torch.device("meta"), None)
    assert round(spec.nbytes(*args) / 1e6, 1) == BYTES_MB[spec.name]
    ms, by = spec.bound_ms(*args)
    assert by == "bytes"
    assert ms == pytest.approx(spec.nbytes(*args) / 3.35e12 * 1e3)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the package, it fails too
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120,
                           env={k: v for k, v in os.environ.items()
                                if k != "PYTHONPATH"})
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout
