"""Deterministic fault injection for the real-time serving path.

The port of ``repro/ft/inject.py``.  The serving stack has three
host-side choke points that every piece of work passes through:

  ``verb``   ``Communicator`` verb dispatch (``container``/``bcast``/
             ``scatter``/``gather``/``copy``/the eager ``allreduce``:
             every payload entering or moving across the group);
  ``task``   ``repro_torch.task.Executor`` task dispatch (every node of
             every frame or tick graph, immediately before its ``fn``);
  ``step``   ``StreamScheduler`` handing a batch to ``Workload.step``
             (every serving tick, with the per-client items visible).

A :class:`FaultInjector` installs itself at all three (the module-level
hooks ``core.env.VERB_HOOK``, ``task.executor.TASK_HOOK`` and
``serve.scheduler.STEP_HOOK``, so the lower layers never import this
package) and fires :class:`FaultSpec` faults:

  ``transient``    raise :class:`TransientFault` (retryable: the
                   Executor's retry policy and the scheduler's tick
                   requeue both key off ``exc.transient``);
  ``corrupt``      poison every inexact array leaf of the payload with
                   NaN (what a flaky link or DMA error looks like to the
                   math: the quarantine path's input);
  ``straggle``     sleep ``delay_ms`` before dispatch (a slow device or
                   contended link; feeds the deadline ladder);
  ``device_loss``  raise :class:`DeviceLossFault` carrying the unhealthy
                   rank (not retryable: the caller remeshes through
                   ``Environment.survivor`` and ``ft.remesh``).

Every decision is a pure function of ``(seed, spec index, per-spec call
index)``, drawn exactly as the JAX package draws it, so a chaos run
replays from its seed and the two packages fire the same faults over the
same call stream: ``inj.reset()`` rewinds the counters and the same
program gives the same ``fired`` log.  Every rank of a group runs the
same program, so every rank fires the same faults at the same calls.  The
seed defaults to ``$REPRO_FAULT_SEED``, else 0.

>>> from repro_torch.task import Executor, TaskGraph
>>> g = TaskGraph()
>>> _ = g.add("inc", lambda x: x + 1, inputs=("x",), outputs=("y",))
>>> inj = FaultInjector([FaultSpec(site="task", kind="transient",
...                                at=(0,))], seed=7)
>>> with inj:
...     try:
...         Executor().run(g, feeds={"x": 1})
...     except TransientFault as e:
...         print(e)
injected transient at task:inc#0
>>> inj.fired
[('task', 'inc', 0, 'transient')]
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..core.segmented import SegmentedArray

SEED_ENV = "REPRO_FAULT_SEED"

SITES = ("verb", "task", "step")
KINDS = ("transient", "corrupt", "straggle", "device_loss")


class FaultError(RuntimeError):
    """Base class of every injected failure."""

    transient = False


class TransientFault(FaultError):
    """A retryable failure (link hiccup, preempted kernel): retry
    policies and the scheduler's tick requeue key off ``transient``."""

    transient = True


class DeviceLossFault(FaultError):
    """A rank of the group went unhealthy: not retryable.  The handler
    mints a survivor communicator and remeshes the live streams."""

    def __init__(self, msg: str, device: int = 0):
        super().__init__(msg)
        self.device = device


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: where (``site`` and ``match``), what
    (``kind``), and when (explicit call indices ``at`` and/or a
    probability ``prob`` per matching call, capped at ``max_fires``).

    ``at`` indices count this spec's OWN matching calls at its site
    (0-based), so ``match="solve", at=(2,)`` means "the third dispatch of
    a task whose name contains 'solve'" whatever else runs.  ``pick``
    narrows a ``corrupt`` at the ``step`` site to one batch position (one
    client); by default the whole payload is poisoned.  ``device`` is the
    group rank a ``device_loss`` names.
    """

    site: str
    kind: str
    prob: float = 0.0
    at: tuple = ()
    match: str = ""
    delay_ms: float = 1.0
    pick: Optional[int] = None
    device: int = 0
    max_fires: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"site must be one of {SITES}: {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}: {self.kind!r}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1]: {self.prob}")


def _poison_leaf(a):
    """NaN-fill one array leaf of an inexact dtype (elementwise, so a
    tensor keeps its device and dtype); other leaves pass through."""
    if isinstance(a, np.ndarray) and np.issubdtype(a.dtype, np.inexact):
        return np.full_like(a, np.nan)
    if isinstance(a, torch.Tensor) and (a.is_floating_point()
                                        or a.is_complex()):
        return a * float("nan")
    if isinstance(a, SegmentedArray):
        # the verb sites hand containers over: poison the segment, keep
        # the segmentation metadata
        return dataclasses.replace(a, data=_poison_leaf(a.data))
    return a


def poison(payload):
    """NaN-poison every inexact array leaf of a payload (dicts, lists and
    tuples are walked; sessions, strings, ints and bools pass through).
    Returns a new payload: the caller's arrays are left as they are."""
    if isinstance(payload, dict):
        return {k: poison(v) for k, v in payload.items()}
    if isinstance(payload, list):
        return [poison(v) for v in payload]
    if isinstance(payload, tuple):
        items = [poison(v) for v in payload]
        return type(payload)(*items) if hasattr(payload, "_fields") \
            else tuple(items)
    return _poison_leaf(payload)


class FaultInjector:
    """Seed-scheduled chaos at the three serving choke points.

    Use as a context manager: ``with FaultInjector(specs, seed=s):``
    installs the hooks, the body runs under injection, and the exit
    restores the previous hooks, always.  ``fired`` is the replay log:
    ``(site, name, spec-local call index, kind)`` per fired fault.
    """

    def __init__(self, specs, seed: Optional[int] = None):
        self.specs = tuple(specs)
        if seed is None:
            seed = int(os.environ.get(SEED_ENV, "0"))
        self.seed = int(seed)
        self.fired: list[tuple] = []
        self._seen = [0] * len(self.specs)    # matching calls per spec
        self._fires = [0] * len(self.specs)
        self._saved = None

    def reset(self) -> None:
        """Rewind to the start of the schedule: the same program then
        replays the same faults (the determinism contract)."""
        self.fired = []
        self._seen = [0] * len(self.specs)
        self._fires = [0] * len(self.specs)

    def _decide(self, i: int, spec: FaultSpec, idx: int) -> bool:
        if spec.max_fires is not None and self._fires[i] >= spec.max_fires:
            return False
        if idx in spec.at:
            return True
        if spec.prob > 0.0:
            # a pure function of (seed, spec index, spec-local call
            # index): replay-exact, independent of cross-site interleaving,
            # and the JAX package's draw
            r = np.random.default_rng([self.seed, i, idx]).random()
            return bool(r < spec.prob)
        return False

    def fire(self, site: str, name: str, payload=None):
        """Account one call at ``site`` and apply every matching spec.
        Returns the (possibly corrupted) payload; raises for
        ``transient`` and ``device_loss`` fires."""
        for i, spec in enumerate(self.specs):
            if spec.site != site or spec.match not in name:
                continue
            idx = self._seen[i]
            self._seen[i] += 1
            if not self._decide(i, spec, idx):
                continue
            self._fires[i] += 1
            self.fired.append((site, name, idx, spec.kind))
            where = f"{site}:{name}#{idx}"
            if spec.kind == "transient":
                raise TransientFault(f"injected transient at {where}")
            if spec.kind == "device_loss":
                raise DeviceLossFault(
                    f"injected device loss at {where} "
                    f"(device {spec.device})", device=spec.device)
            if spec.kind == "straggle":
                time.sleep(spec.delay_ms / 1e3)
            elif spec.kind == "corrupt":
                if spec.pick is not None and isinstance(payload, list):
                    payload = [poison(p) if j == spec.pick else p
                               for j, p in enumerate(payload)]
                else:
                    payload = poison(payload)
        return payload

    # -- hook plumbing ----------------------------------------------------
    def _on_verb(self, name, payload):
        return self.fire("verb", name, payload)

    def _on_task(self, task, args):
        return self.fire("task", task.name, args)

    def _on_step(self, workload, batch):
        return self.fire("step", type(workload).__name__, batch)

    def __enter__(self) -> "FaultInjector":
        from ..core import env as _env
        from ..serve import scheduler as _sched
        from ..task import executor as _exec
        if self._saved is not None:
            raise RuntimeError("FaultInjector is not reentrant")
        self._saved = (_env.VERB_HOOK, _exec.TASK_HOOK, _sched.STEP_HOOK)
        _env.VERB_HOOK = self._on_verb
        _exec.TASK_HOOK = self._on_task
        _sched.STEP_HOOK = self._on_step
        return self

    def __exit__(self, *exc) -> None:
        from ..core import env as _env
        from ..serve import scheduler as _sched
        from ..task import executor as _exec
        _env.VERB_HOOK, _exec.TASK_HOOK, _sched.STEP_HOOK = self._saved
        self._saved = None
