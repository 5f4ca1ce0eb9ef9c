"""Plan / PlanCache: re-export of :mod:`repro_torch.core.plan`, at the
``lib`` import path the JAX package also keeps.  Everything, the shared
default cache included, is the same object.

>>> cache = PlanCache(maxsize=8)          # a private cache
>>> cache.get_or_build(("demo",),
...                    lambda: Plan(key=("demo",), fn=lambda: 7))()
7
>>> len(cache), cache is default_cache()
(1, False)
"""

from __future__ import annotations

from ..core.plan import (  # noqa: F401
    Plan,
    PlanCache,
    default_cache,
    device_token,
    group_token,
    plan_stats,
    seg_token,
)

__all__ = ["Plan", "PlanCache", "default_cache", "device_token",
           "group_token", "plan_stats", "seg_token"]
