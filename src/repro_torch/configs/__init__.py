"""Architecture registry of the port: ``--arch <id>`` ids -> (full, smoke)
configs, as ``repro/configs/__init__.py``.  Every id is ported: the dense
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


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
