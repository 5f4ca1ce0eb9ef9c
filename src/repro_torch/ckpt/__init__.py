"""Checkpoints: the port of ``repro.ckpt``."""

from .checkpoint import (latest_step, list_steps, restore, restore_sharded,
                         save)

__all__ = ["save", "restore", "restore_sharded", "list_steps", "latest_step"]
