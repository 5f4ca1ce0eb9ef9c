"""Architecture registry of the port: ``--arch <id>`` ids -> (full, smoke)
configs, the assigned input-shape set and the per-cell applicability
rule, as ``repro/configs/__init__.py``.  Every id is ported: the dense
attention archs, MLA (``minicpm3-4b``, ``deepseek-v2-lite-16b``), MoE
(``granite-moe-3b-a800m``, deepseek), cross-attention with the stubbed
frontends (``llama-3.2-vision-11b``, ``whisper-tiny`` with its encoder),
the hybrid ``recurrentgemma-2b`` and the xLSTM ``xlstm-350m``.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "xlstm-350m", "minicpm3-4b", "qwen3-0.6b", "gemma2-27b", "llama3.2-3b",
    "recurrentgemma-2b", "llama-3.2-vision-11b", "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b", "whisper-tiny",
]
PORTED = tuple(ARCH_IDS)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}

# shape id -> (seq_len, global_batch, step kind)
SHAPES = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE


def cell_applicable(cfg, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch, shape) cell."""
    if shape == "long_500k" and not cfg.is_subquadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic"
    return True, ""


def input_specs(cfg, shape: str, *, mesh=None):
    """Meta-tensor stand-ins for every input of the step function (the
    dry-run contract: the shapes and dtypes, no allocation): ``tokens``
    (and ``labels`` in train) int32, a decode's ``cache``
    (``transformer.init_cache`` on meta) and ``pos`` (a 0-d int32), and
    the frontend's ``enc`` outside decode.  ``mesh`` is taken, as the JAX
    package's is, and changes nothing."""
    import torch

    from ..models import frontends, transformer

    seq, gbatch, kind = SHAPES[shape]

    def ints(*s):
        return torch.empty(s, dtype=torch.int32, device="meta")
    specs = {}
    if kind == "train":
        specs["tokens"] = ints(gbatch, seq)
        specs["labels"] = ints(gbatch, seq)
    elif kind == "prefill":
        specs["tokens"] = ints(gbatch, seq)
    elif kind == "decode":
        specs["tokens"] = ints(gbatch, 1)
        specs["cache"] = transformer.init_cache(cfg, gbatch, seq, cfg.cdtype,
                                                device="meta")
        specs["pos"] = ints()
    fr = frontends.frontend_struct(cfg, gbatch, cfg.cdtype)
    if fr is not None and kind != "decode":
        specs["enc"] = fr
    return specs
