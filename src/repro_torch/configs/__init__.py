"""Architecture registry of the port: ``--arch <id>`` ids -> (full, smoke)
configs, as ``repro/configs/__init__.py``.

Two are ported: ``recurrentgemma-2b`` (layer kinds ``rglru`` and
``local`` attention) and ``xlstm-350m`` (``mlstm`` and ``slstm``).  The
other eight ids are listed, and asking for them raises until their layer
kinds are ported (ROADMAP Queue 1, the other LM configs).
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "xlstm-350m", "minicpm3-4b", "qwen3-0.6b", "gemma2-27b", "llama3.2-3b",
    "recurrentgemma-2b", "llama-3.2-vision-11b", "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b", "whisper-tiny",
]
PORTED = ("recurrentgemma-2b", "xlstm-350m")

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch}: its layer kinds are not ported yet (ROADMAP Queue 1, "
            f"the other LM configs); ported: {list(PORTED)}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke(arch: str):
    return _module(arch).SMOKE
