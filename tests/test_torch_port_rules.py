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
from repro_torch.kernels.flash_attention import MLA_CASES, MLA_SEQ

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
            "repro_torch.train, repro_torch.data, repro_torch.ckpt, "
            "repro_torch.ft, repro_torch.launch.train, "
            "repro_torch.launch.serve, repro_torch.launch.mesh, "
            "repro_torch.models.sharding, "
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
                 lambda: Reconstructor(comm=None),
                 lambda: Environment().group((1, 1), ("pod", "data")),
                 lambda: Environment().survivor(cpu),
                 lambda: DeviceGroup.mesh((1, 1), ("pod", "data"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert Environment(device="cpu").world.device.type == "cpu"
    env = Environment(device="cpu")
    assert env.group((1, 1), ("pod", "data")).device.type == "cpu"
    assert env.survivor(cpu) is cpu
    assert rank_device(3, device="cpu").type == "cpu"
    assert Reconstructor(cpu).device.type == "cpu"
    seg = convert.segmented_from_numpy([1.0, 2.0], cpu)
    assert seg.device.type == "cpu"


def test_lm_entry_points_need_the_card_unless_asked(monkeypatch):
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.models import frontends, transformer
    from repro_torch.serve import Engine, make_serve_steps
    cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                              compute_dtype="float32")
    whisper = get_smoke("whisper-tiny")
    model = transformer.init_params(cfg, device="cpu")
    tree = convert.params_to_numpy(cfg, model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: transformer.init_params(cfg),
                 lambda: transformer.init_cache(cfg, 1, 8, torch.float32),
                 lambda: convert.params_from_numpy(cfg, tree),
                 lambda: make_serve_steps(cfg, max_len=8, batch=1),
                 lambda: frontends.synthetic_frontend(whisper, 1),
                 lambda: Engine(cfg, model, batch=1, max_len=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = Engine(cfg, model, batch=1, max_len=8, device="cpu")
    assert eng.workload.device.type == "cpu"
    assert frontends.synthetic_frontend(whisper, 1, device="cpu").shape == \
        (1, whisper.encoder_seq, whisper.d_model)


TRAIN_SUBPACKAGES = ("train", "data", "ckpt", "launch")


@pytest.mark.parametrize("sub", TRAIN_SUBPACKAGES)
def test_training_subpackages_are_checked(sub):
    """The training path's subpackages are among the files that the import
    rule above reads."""
    files = sorted((PORT / sub).glob("*.py"))
    assert files and set(files) <= set(PORT_FILES)


SHARDED_SERVING_FILES = ("models/sharding.py", "launch/mesh.py",
                         "launch/serve.py")


@pytest.mark.parametrize("rel", SHARDED_SERVING_FILES)
def test_sharded_serving_files_are_checked(rel):
    """Tensor-parallel serving's modules are among the files that the
    import rule above reads."""
    assert PORT / rel in PORT_FILES


def test_sharded_serving_entry_points_need_the_card_unless_asked(
        monkeypatch):
    """The serving launcher and a sharded step's mesh run on the card
    unless asked for the CPU, and raise without one."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import Communicator
    from repro_torch.launch.serve import main
    from repro_torch.models import sharding
    from repro_torch.serve import make_serve_steps
    cfg = get_smoke("qwen3-0.6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: main(["--smoke", "--requests", "1"]),
                 lambda: make_serve_steps(cfg, Communicator.single()),
                 lambda: sharding.init_shards(cfg, Communicator.single())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    mesh = Communicator.single("cpu")
    params = sharding.init_shards(cfg, mesh)
    assert params.embed.device.type == "cpu"
    prefill, _, init_cache = make_serve_steps(cfg, mesh, max_len=8, batch=1)
    assert init_cache()[0]["attn"]["k"].device.type == "cpu"


def test_train_entry_points_need_the_card_unless_asked(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import main
    from repro_torch.train import make_train_state
    cfg = get_smoke("qwen3-0.6b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_train_state(cfg),
                 lambda: main(["--smoke", "--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    state = make_train_state(cfg, device="cpu")
    assert state["params"].device.type == "cpu"
    assert state["opt"]["step"].device.type == "cpu"


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


def test_checkpoint_recompute_keeps_the_plain_block_in_another_thread():
    """A checkpointed layer is recomputed in the backward, which on CUDA
    runs in the autograd engine's own thread, where ``plain()``'s context
    variable is not set: ``checkpoint_contexts`` (taken in the forward)
    gives a recompute context that sets it again, and none outside a
    plain block."""
    import threading
    t = torch.empty(2, device="meta")
    with registry.plain():
        _, inside = registry.checkpoint_contexts()
    _, outside = registry.checkpoint_contexts()
    seen = {}

    def recompute(name, ctx):
        with ctx:
            try:
                seen[name] = registry.use_kernel("auto", t)
            except ValueError:
                seen[name] = "kernel"
    for name, ctx in (("inside", inside), ("outside", outside)):
        th = threading.Thread(target=recompute, args=(name, ctx))
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    assert seen == {"inside": False, "outside": "kernel"}


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


# Flash attention with v's own head dim at the MLA prefills that
# chip_smoke.py times (bf16, B = 1, 2048 tokens, causal: 2,098,176 live
# pairs a head): 2 (D + Dv) flops a live pair, q and k of D, v and the
# output of Dv.  deepseek-v2-lite-16b: 16 heads of 192 / 128, 2.149e10
# flops (0.0217 ms on the bf16 tensor cores) against 41.9 MB (0.0125 ms);
# minicpm3-4b: 40 heads of 96 / 64, 2.686e10 flops (0.0272 ms) against
# 52.4 MB.
MLA_BOUNDS = {"deepseek-v2-lite-16b": (21_485_322_240, 41_943_040),
              "minicpm3-4b": (26_856_652_800, 52_428_800)}


@pytest.mark.parametrize("case", MLA_CASES, ids=lambda c: c[0])
def test_flash_attention_bound_at_the_mla_shapes(case):
    from repro_torch.configs import get_config
    name, B, H, S, D, Dv = case
    cfg = get_config(name)
    assert (H, D, Dv) == (cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim,
                          cfg.v_head_dim) and S == MLA_SEQ
    spec = registry.get("flash_attention")
    q, k, v = (torch.empty(sh, dtype=torch.bfloat16, device="meta")
               for sh in ((B, H, S, D), (B, H, S, D), (B, H, S, Dv)))
    args = (q, k, v, {"causal": True}, None)
    assert (spec.flops(*args), spec.nbytes(*args)) == MLA_BOUNDS[name]
    ms, by = spec.bound_ms(*args)
    assert by == "operations"
    assert ms == pytest.approx(MLA_BOUNDS[name][0] / 989e12 * 1e3)


# The batched masked_sum at the 4-rank service's shapes: the 4 ranks'
# gathered 384 x 384 FOV windows of B = 2 clients, (4, 2, 384, 384)
# complex64, the one shared float32 mask and the (2, 384, 384) output:
# 12.4 MB, bytes-bound at 0.0037 ms.
def test_batched_masked_sum_bound_at_the_service_shapes():
    spec = registry.get("masked_sum")
    args = spec.sample(torch.device("meta"), None, width=2)
    assert tuple(args[0].shape) == (4, 2, 384, 384)
    assert spec.nbytes(*args) == 12_386_304
    ms, by = spec.bound_ms(*args)
    assert by == "bytes"
    assert ms == pytest.approx(12_386_304 / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0037, abs=5e-5)


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


def test_mlstm_wgmma_rows():
    """The bf16 route's wgmma kernels read rows of a multiple of 16 bytes
    on 16-byte aligned bases: the scratch's planes round dv up to 8
    elements on that route alone (the served shape's bytes unchanged), and
    ``tma_rows`` pads q, k and v to such rows with zeros or copies an
    unaligned base, and leaves served operands and non-contiguous ones
    (which the launch refuses) as they are."""
    from repro_torch.kernels.mlstm.ops import (scratch_bytes, scratch_shapes,
                                               tma_rows)
    bf = torch.bfloat16
    assert scratch_bytes(1, 4, 3072, 512, 512, dtype=bf) == \
        MLSTM_SCRATCH_BYTES
    assert scratch_shapes(1, 2, 150, 40, 20, dtype=bf)[0] == (1, 2, 2, 40, 24)
    assert scratch_shapes(1, 2, 150, 40, 20, dtype=torch.float32)[0] == \
        (1, 2, 2, 40, 20)
    # a head past 512 takes the CUDA-core passes: float32 rows as before
    assert scratch_shapes(1, 1, 200, 1056, 90, dtype=bf)[0] == \
        (1, 1, 2, 1056, 90)
    x = torch.randn(1, 2, 5, 100).to(bf)
    y = tma_rows(x)
    assert y.shape == (1, 2, 5, 104) and torch.equal(y[..., :100], x)
    assert not y[..., 100:].any()
    z = torch.randn(1, 2, 5, 64).to(bf)
    assert tma_rows(z) is z
    assert not tma_rows(z.transpose(2, 3)).is_contiguous()
    buf = torch.zeros(z.numel() + 1, dtype=bf)
    off = buf[1:].view(z.shape)
    off.copy_(z)
    moved = tma_rows(off)
    assert off.data_ptr() % 16 and moved.data_ptr() % 16 == 0
    assert torch.equal(moved, z)


def test_rg_lru_scratch_at_the_served_shape():
    """The RG-LRU kernel's scratch, its int64 state on each stream: the
    ticket counter, then each chunk but the last's aggregate (a tagged
    word for its decay and one for its end state, per lane), 23 chunks of
    128 steps before the last at the served (1, 3072, 2560); the counter
    alone for a sequence of one chunk or less.  A block's tile is 256
    bytes of lanes (64 float32, walked in 4 parts; 128 bf16, in 2) by 128
    steps, 64 KB of a block's shared memory; the served shape takes the
    TMA loader, a row that is not a multiple of 16 bytes or an unaligned
    base the threads'."""
    from repro_torch.kernels.rg_lru.ops import (CHUNK, lanes, loader, parts,
                                                state_words, tile_bytes)
    la, b, h0 = registry.get("rg_lru").sample(torch.device("meta"), None)
    assert CHUNK == 128
    assert state_words(*b.shape) == 1 + 2 * 23 * 2560
    assert state_words(1, 129, 8) == 1 + 2 * 8
    assert state_words(2, 128, 8) == state_words(2, 0, 8) == 1
    assert state_words(2, 300, 2567) == 1 + 2 * 2 * 2 * 2567
    assert (lanes(torch.float32), lanes(torch.bfloat16)) == (64, 128)
    assert (parts(torch.float32), parts(torch.bfloat16)) == (4, 2)
    assert tile_bytes() == 65536
    assert loader(3072, 2560, torch.float32, 0, 256, 512) == "tma"
    assert loader(1000, 96, torch.bfloat16, 16, 32, 48) == "tma"
    assert loader(17, 2567, torch.float32, 0, 0, 0) == "threads"
    assert loader(1, 33, torch.float32, 0, 0, 0) == "threads"
    assert loader(64, 96, torch.bfloat16, 0, 8, 0) == "threads"
    assert loader(64, 96, torch.bfloat16, 0, 0, 8) == "threads"
    assert loader(0, 32, torch.float32, 0, 0, 0) == "threads"


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
    rest on it): no source sums with an atomic.  The one atomic allowed
    hands out work: an ``atomicAdd`` of 1 on an integer ticket counter
    (the RG-LRU scan's tiles, taken in chunk order), whose order decides
    which block takes which tile, never an order of summation."""
    text = re.sub(r"//[^\n]*", "", src.read_text())
    calls = re.findall(r"\batomic\w*\s*\([^;]*;", text)
    for call in calls:
        m = re.fullmatch(r"atomicAdd\((\w+), 1U?L?L?\);", call)
        assert m, (src.name, call)
        assert re.search(r"unsigned long long\*\s*__restrict__\s+" +
                         m.group(1) + r"\b", text), (src.name, call)
    assert len(calls) <= 1, src.name


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


# the reference's parameters the port leaves out, each for a reason: the
# port's verbs take this rank's tensor with the communicator bound, so
# there is no in-shard_map ``axis``; ``spmd`` compiles nothing, so it has
# no JAX compile options; there is no mesh object to wrap
_NOT_PORTED = {"axis", "check_vma", "donate_argnums", "jit"}
_RENAMED = {"arrays": "tensors"}


def test_communicator_keeps_the_reference_verb_surface():
    """Every public method of the JAX package's ``Communicator`` and
    ``Environment`` (the snapshot of ``tests/test_api_surface.py``) is in
    the port under its name, with the reference's parameters in the
    reference's order, but for ``_NOT_PORTED`` (and ``from_mesh``)."""
    import inspect

    from test_api_surface import EXPECTED_COMMUNICATOR, EXPECTED_ENVIRONMENT
    from repro_torch.core import Communicator, Environment
    for expected, cls in ((EXPECTED_COMMUNICATOR, Communicator),
                          (EXPECTED_ENVIRONMENT, Environment)):
        for name, params in expected.items():
            if name == "from_mesh":
                continue
            got = tuple(inspect.signature(getattr(cls, name)).parameters)
            want = tuple(_RENAMED.get(p, p) for p in params
                         if p not in _NOT_PORTED)
            assert tuple(p for p in got if p in want) == want, \
                (cls.__name__, name, got, want)
