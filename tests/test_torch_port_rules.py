"""Rules the port keeps: it stands apart from the JAX package, runs on the
card unless asked for the CPU, and every kernel in its registry names the
TPU kernel it replaces and has a plain version beside it."""

import ast
import os
import pathlib
import re
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
            " repro_torch.core, repro_torch.core.plan, repro_torch.core.comm,"
            " repro_torch.core.launch, repro_torch.core.sync, "
            "repro_torch.lib.plan, repro_torch.lib.blas, "
            "repro_torch.kernels.masked_allreduce, "
            "repro_torch.lib.fft, repro_torch.lib.gridding, "
            "repro_torch.configs, repro_torch.models, repro_torch.serve, "
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


def test_multirank_entry_points_need_the_card_unless_asked(monkeypatch):
    """The multi-rank core's entry points put a rank on the card unless
    asked for the CPU, and raise without one."""
    from repro_torch import convert
    from repro_torch.core import Communicator, DeviceGroup, Environment
    from repro_torch.device import rank_device
    from repro_torch.nlinv.recon import Reconstructor
    cpu = Communicator.single("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (Environment, Communicator.single, DeviceGroup.single,
                 DeviceGroup.all_devices, lambda: rank_device(0),
                 lambda: rank_device(1, shared=True),
                 lambda: Reconstructor(comm=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Environment(device="cpu").world.device.type == "cpu"
    assert rank_device(3, device="cpu").type == "cpu"
    assert Reconstructor(cpu).device.type == "cpu"
    seg = convert.segmented_from_numpy([1.0, 2.0], cpu)
    assert seg.device.type == "cpu"


def test_lm_entry_points_need_the_card_unless_asked(monkeypatch):
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer
    from repro_torch.serve import Engine, make_serve_steps
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              compute_dtype="float32")
    model = transformer.init_params(cfg, device="cpu")
    tree = convert.params_to_numpy(cfg, model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: transformer.init_params(cfg),
                 lambda: transformer.init_cache(cfg, 1, 8, torch.float32),
                 lambda: convert.params_from_numpy(cfg, tree),
                 lambda: make_serve_steps(cfg, max_len=8, batch=1),
                 lambda: Engine(cfg, model, batch=1, max_len=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = Engine(cfg, model, batch=1, max_len=8, device="cpu")
    assert eng.workload.device.type == "cpu"


def _script_constants(path) -> dict:
    """A script's module-level literal constants, read without running
    it."""
    pairs = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if isinstance(target, ast.Name):
                pairs.append((target.id, node.value))
            elif isinstance(target, ast.Tuple) and \
                    isinstance(node.value, ast.Tuple):
                pairs += [(t.id, v) for t, v in zip(target.elts,
                                                    node.value.elts)]
    out = {}
    for name, value in pairs:
        try:
            out[name] = ast.literal_eval(value)
        except ValueError:          # not a literal (a path, a call)
            pass
    return out


def test_lm_kernel_shapes_are_the_served_model_and_prompt():
    """The registry's LM sample shapes (its kernel rows' bounds) are
    recurrentgemma-2b's widths and the longest prompt that chip_smoke.py
    serves and profile_frame.py profiles."""
    from repro_torch.configs import get_config
    smoke = _script_constants(ROOT / "chip_smoke.py")
    prof = _script_constants(ROOT / "profile_frame.py")
    assert smoke["LM_ARCH"] == prof["LM_ARCH"] == "recurrentgemma-2b"
    cfg = get_config(smoke["LM_ARCH"])
    assert (registry.LM_HEADS, registry.LM_KV_HEADS, registry.LM_HEAD_DIM,
            registry.LM_WINDOW, registry.LM_LRU_WIDTH) == (
        cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window, cfg.rnn_width)
    assert registry.LM_SEQ == max(smoke["LM_PROMPTS"]) == prof["LM_PROMPT"]


def test_xlstm_kernel_shapes_are_the_served_model_and_prompt():
    """The registry's mLSTM sample shape (its kernel row's bound) is
    xlstm-350m's heads and head dim and the longest prompt that
    chip_smoke.py serves and profile_frame.py profiles."""
    from repro_torch.configs import get_config
    smoke = _script_constants(ROOT / "chip_smoke.py")
    prof = _script_constants(ROOT / "profile_frame.py")
    assert smoke["XLSTM_ARCH"] == prof["XLSTM_ARCH"] == "xlstm-350m"
    cfg = get_config(smoke["XLSTM_ARCH"])
    assert registry.XLSTM_HEADS == cfg.rnn_heads
    assert registry.XLSTM_HEAD_DIM == \
        int(cfg.d_model * cfg.proj_factor) // cfg.rnn_heads
    assert registry.XLSTM_SEQ == max(smoke["XLSTM_PROMPTS"]) == \
        prof["XLSTM_PROMPT"]


def test_plain_block_asks_every_wrapper_for_its_plain_version():
    """``registry.plain()`` turns the card's dispatch to the plain version
    for its block only, nested or not (meta tensors stand in for a
    device without a plain path)."""
    t = torch.empty(2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        registry.use_kernel("auto", t)
    with registry.plain():
        assert not registry.use_kernel("auto", t)
        with registry.plain():
            assert not registry.use_kernel("auto", t)
        assert not registry.use_kernel("auto", t)
    with pytest.raises(ValueError, match="no kernel"):
        registry.use_kernel("auto", t)


def test_registry_holds_the_fourteen_kernels_in_table_order():
    """The frame's seven kernels, the segmented BLAS's and the
    distributed frame's two, then the radial path's two, then the LM
    serving path's two for recurrentgemma-2b and one for xlstm-350m: all
    14 TPU kernels, in the kernel table's order."""
    names = [s.name for s in registry.specs()]
    assert names == ["coil_forward", "coil_lincomb", "coil_scale_mult",
                     "plane_mult", "coil_adjoint", "cg_update", "xpby",
                     "xpby_dot", "masked_sum", "degrid", "grid_adjoint",
                     "flash_attention", "rg_lru", "mlstm"]


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
    assert spec.tol in (1e-5, 1e-4, 1e-3, 2e-3)


# The main path's byte budgets (J = 8 on the 768 x 768 grid): every input
# read once, every output written once.  coil_adjoint is called without a
# mask on the main path, so its budget has no mask plane.  The gridding
# rows are the gather form's bytes for frame 0's trajectory (11 spokes of
# 1536 samples): degrid reads the 19887 grid cells the samples touch, per
# coil, plus the taps and writes the samples; grid_adjoint reads the
# samples and the taps and writes the whole grid.  Both count the taps,
# the operator's own form, and not the index that one kernel or another
# keeps beside them, so that the bound prices the work and not the
# implementation (a full-grid CSR pointer would add 2.4 MB).  The TPU
# form's dense matrices alone would be 103.8 MB.  The LM rows are the prefill of
# recurrentgemma-2b's longest served prompt (S = 3072): flash attention
# reads q, k, v and writes out in bf16 (10 query heads, one kv head, D =
# 256) and does 4 D flops per live (query, key) pair, 4,195,328 pairs a
# head under the causal 2048-key window, so the bf16 tensor cores' rate
# bounds it; the RG-LRU scan reads log_a and b and writes h in float32
# (W = 2560), plus h0 and h_last.  The mLSTM row is xlstm-350m's prefill
# of the same prompt (4 heads, dk = dv = 512): q, k, v and h in bf16, the
# gates in float32 and the state (C, n, m) read and written in float32;
# the chunkwise form at chunk 128 does q k^T and scores v at 2 L^2 512
# flops each and q C and k^T v at 2 L 512^2 each, a chunk (n_t = D k is
# never formed: q . n_t is the row sum of the masked scores), which at
# the bf16 tensor cores' rate takes less time than its bytes, so the
# bytes bound it.  The two kernels of the 4-rank paths work on one rank's
# share: xpby_dot on the 2-coil segment of the chat leaf (x, y and w, plus
# beta and d), masked_sum on the 4 gathered 384 x 384 FOV windows (the
# partials and the mask read, one window written).
BYTES_MB = {"coil_forward": 80.2, "coil_lincomb": 125.0,
            "coil_scale_mult": 82.6, "plane_mult": 77.9,
            "coil_adjoint": 80.2, "cg_update": 226.5, "xpby": 113.2,
            "xpby_dot": 28.3, "masked_sum": 6.5, "degrid": 2.9, "grid_adjoint": 39.4, "flash_attention": 34.6,
            "rg_lru": 94.4, "mlstm": 58.8}
FLOPS = {"flash_attention": 42_960_158_720, "mlstm": 16_106_127_360}
BOUND_BY = {"flash_attention": "operations", "mlstm": "bytes"}


@pytest.mark.parametrize("spec", registry.specs(), ids=lambda s: s.name)
def test_spec_bound_at_main_path_shapes(spec):
    args = spec.sample(torch.device("meta"), None)
    assert round(spec.nbytes(*args) / 1e6, 1) == BYTES_MB[spec.name]
    ms, by = spec.bound_ms(*args)
    if spec.name in FLOPS:
        assert spec.flops(*args) == FLOPS[spec.name]
        assert by == BOUND_BY[spec.name]
        assert ms == pytest.approx(max(
            FLOPS[spec.name] / 989e12 * 1e3,
            spec.nbytes(*args) / 3.35e12 * 1e3))
    else:
        assert by == "bytes"
        assert ms == pytest.approx(spec.nbytes(*args) / 3.35e12 * 1e3)


# The mLSTM kernel's scratch at the served shape (xlstm-350m's 4 heads of
# dim 512 over 3072 steps, 24 chunks of 128): the state entering each
# chunk, (4, 24, 512, 512) elements of 4 bytes (100,663,296 bytes, 100.7
# MB; float32 on the CUDA-core route, two bf16 planes hi and lo on the
# tensor-core route), the entering n (4, 24, 512) float32 and three
# scalars a chunk.  csrc/mlstm.cu's header and PERF.md quote it.
MLSTM_SCRATCH_BYTES = 100_861_056


def test_mlstm_scratch_at_the_served_shape():
    from repro_torch.kernels.mlstm.ops import scratch_bytes, scratch_shapes
    args = registry.get("mlstm").sample(torch.device("meta"), None)
    B, H, S, dk = args[0].shape
    assert scratch_bytes(B, H, S, dk, args[2].shape[-1]) == \
        MLSTM_SCRATCH_BYTES
    states, ns, scalars = scratch_shapes(B, H, S, dk, dk)
    assert states == (1, 4, 24, 512, 512) and 4 * 4 * 24 * 512 * 512 == \
        100_663_296
    assert ns == (1, 4, 24, 512) and scalars == (3, 1, 4, 24)
    # a ragged last chunk is a chunk of its own; a short S is one chunk
    assert scratch_shapes(1, 1, 129, 8, 8)[0] == (1, 1, 2, 8, 8)
    assert scratch_shapes(1, 1, 5, 8, 8, chunk=128)[0] == (1, 1, 1, 8, 8)


def test_rg_lru_scratch_at_the_served_shape():
    """The RG-LRU kernel's scratch: each chunk but the last's decay and
    end state, float32, 23 chunks of 128 steps before the last at the
    served (1, 3072, 2560); none for a sequence of one chunk or less."""
    from repro_torch.kernels.rg_lru.ops import CHUNK, scratch_shape
    la, b, h0 = registry.get("rg_lru").sample(torch.device("meta"), None)
    assert CHUNK == 128
    assert scratch_shape(*b.shape) == (2, 23, 1, 2560)
    assert scratch_shape(1, 129, 8) == (2, 1, 1, 8)
    assert scratch_shape(2, 128, 8) == scratch_shape(2, 0, 8) == (2, 0, 2, 8)


def test_profile_groups_every_port_kernel():
    """profile_frame.py files every __global__ kernel of the port's CUDA
    sources under a port group, so that a renamed kernel still counts as
    the port's time in the prefill and frame breakdowns; the LM scans'
    kernels under their own groups."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "profile_frame", ROOT / "profile_frame.py")
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s+)?(\w+)\s*\(")
    own = {"flash_attention": "port CUDA kernel: flash attention",
           "rg_lru": "port CUDA kernel: RG-LRU scan",
           "mlstm": "port CUDA kernel: mLSTM"}
    seen = 0
    for src in sorted((PORT / "kernels" / "csrc").glob("*.cu")):
        for name in pattern.findall(src.read_text()):
            # as the profiler names it: namespace, template, arguments
            key = f"void (anonymous namespace)::{name}<float>(float const*)"
            assert prof._group(key) == own.get(src.stem,
                                               "port CUDA kernels"), name
            seen += 1
    assert seen >= 20


@pytest.mark.parametrize("src", sorted((PORT / "kernels" / "csrc").glob(
    "*.cu")), ids=lambda p: p.name)
def test_kernel_sources_use_no_atomics(src):
    """Every reduction of the port's kernels runs in a fixed order, so that
    two calls give the same bits (the JAX package's bitwise assertions
    rest on it): no source calls an atomic."""
    text = re.sub(r"//[^\n]*", "", src.read_text())
    assert not re.search(r"\batomic\w*\s*\(", text), src.name


# The two kernels ported last, priced by their specs at the one-rank
# frame's width as the kernel table priced them before they were ported:
# xpby_dot over the whole chat leaf (J = 8 on the 768 x 768 grid: x, y
# and w, beta and d), masked_sum over G = 4 whole-grid partials (the TPU
# kernel's re and im planes are the same bytes as complex64), the float32
# mask and the output.
UNPORTED_MB = {"xpby_dot": 113.2, "masked_sum": 26.0}


def _unported_operands(name):
    meta = torch.device("meta")
    spec = registry.get(name)
    if name == "xpby_dot":
        return spec.sample(meta, None, ncoils=registry.MAIN_NCOILS)
    return spec.sample(meta, None, nparts=registry.MAIN_RANKS,
                       size=registry.MAIN_GRID)


@pytest.mark.parametrize("name", sorted(UNPORTED_MB))
def test_last_ported_kernels_bound_at_frame_shapes(name):
    spec = registry.get(name)
    args = _unported_operands(name)
    assert round(spec.nbytes(*args) / 1e6, 1) == UNPORTED_MB[name]
    # a few flops per element against 8+ bytes: the bytes bound them
    ms, by = spec.bound_ms(*args)
    assert by == "bytes"
    assert ms == pytest.approx({"xpby_dot": 0.0338,
                                "masked_sum": 0.00775}[name], abs=5e-5)


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
