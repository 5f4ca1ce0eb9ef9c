"""``Plan`` and ``PlanCache``: the plan substrate, below every layer of the
port.  ``repro_torch.core.plan`` re-exports both with the keys that
describe tensors and groups; the kernel registry keeps its block
decisions in a ``PlanCache`` of its own (``registry.tune_cache``), so
the classes live under the kernels, which import no layer above them.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable


@dataclasses.dataclass
class Plan:
    """One built library plan: an executable bound to an immutable key.

    ``fn`` is the program; ``meta`` carries whatever its build step
    wants reports to see.

    >>> p = Plan(key=("square", 3), fn=lambda x: x ** 2,
    ...          lib="libdemo", op="square")
    >>> p(4)
    16
    >>> Plan.value(("blocks",), (8, 8))()   # a cached decision
    (8, 8)
    """

    key: tuple
    fn: Callable
    lib: str = ""
    op: str = ""
    meta: dict = dataclasses.field(default_factory=dict)

    def __call__(self, *args, **kw):
        return self.fn(*args, **kw)

    @classmethod
    def value(cls, key: tuple, payload: Any, lib: str = "", op: str = "",
              meta: dict | None = None) -> "Plan":
        """A plan whose program is a cached decision: calling it returns
        ``payload``."""
        return cls(key=key, fn=lambda: payload, lib=lib, op=op,
                   meta=dict(meta or {}))

    def __repr__(self) -> str:
        return f"Plan({self.lib}.{self.op}, key_hash={hash(self.key):#x})"


class PlanCache:
    """LRU-bounded plan store with hit/miss/eviction counters.

    A lookup that misses runs ``build()`` once and caches the result.
    Counters are cumulative; ``snapshot()``/``delta()`` show what one
    region (a streamed frame, a pass over frames) did to the cache.

    >>> cache = PlanCache(maxsize=2)
    >>> build = lambda: Plan(key=("square", 3), fn=lambda x: x ** 2)
    >>> cache.get_or_build(("square", 3), build)(4)    # miss: builds
    16
    >>> cache.get_or_build(("square", 3), build)(5)    # hit
    25
    >>> s = cache.stats()
    >>> (s["hits"], s["misses"], s["size"])
    (1, 1, 1)
    >>> cache.delta(s)["builds"]     # a steady region builds nothing
    0
    """

    def __init__(self, maxsize: int = 256):
        if maxsize < 1:
            raise ValueError("PlanCache needs maxsize >= 1")
        self.maxsize = maxsize
        self._plans: OrderedDict[tuple, Plan] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: tuple) -> bool:
        return key in self._plans

    def get_or_build(self, key: tuple, build: Callable[[], Plan]) -> Plan:
        """Return the cached plan for ``key``, building (and possibly
        evicting the least-recently-used plan) on a miss."""
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
                self._plans.move_to_end(key)
                return plan
            self.misses += 1
        # build outside the lock: a build may take a while
        plan = build()
        if not isinstance(plan, Plan):
            plan = Plan(key=key, fn=plan)
        with self._lock:
            existing = self._plans.get(key)
            if existing is not None:
                # another thread built the same key meanwhile: keep the
                # first build so every caller shares one plan object
                self._plans.move_to_end(key)
                return existing
            self._plans[key] = plan
            self._plans.move_to_end(key)
            while len(self._plans) > self.maxsize:
                self._plans.popitem(last=False)
                self.evictions += 1
        return plan

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()

    # -- reporting --------------------------------------------------------
    @property
    def builds(self) -> int:
        """Total plans built (== misses: every miss builds exactly once)."""
        return self.misses

    def snapshot(self) -> dict:
        """Point-in-time counters, cheap enough to take per frame."""
        return {"hits": self.hits, "misses": self.misses,
                "builds": self.builds, "evictions": self.evictions,
                "size": len(self._plans)}

    def delta(self, since: dict) -> dict:
        """Counter movement since a ``snapshot()``: what one measured
        region did to the cache, so that 'the steady state builds
        nothing' is a checkable ``builds == 0``."""
        now = self.snapshot()
        d = {k: now[k] - since[k]
             for k in ("hits", "misses", "builds", "evictions")}
        total = d["hits"] + d["misses"]
        d["hit_rate"] = round(d["hits"] / total, 4) if total else 0.0
        return d

    def stats(self) -> dict:
        """Counters and the derived hit rate, for report artifacts."""
        s = self.snapshot()
        total = s["hits"] + s["misses"]
        s["capacity"] = self.maxsize
        s["hit_rate"] = round(s["hits"] / total, 4) if total else 0.0
        return s

    def __repr__(self) -> str:
        s = self.stats()
        return (f"PlanCache(size={s['size']}/{s['capacity']}, "
                f"hits={s['hits']}, builds={s['builds']}, "
                f"hit_rate={s['hit_rate']})")
