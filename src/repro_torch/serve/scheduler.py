"""One scheduler for N concurrent real-time streams (the serving layer).

The port of ``repro/serve/scheduler.py``, whole: it is pure Python, and
its latency statistics come from the port's ``nlinv.stream``.  A
:class:`StreamScheduler` owns admission, per-client queueing and
backpressure, batch formation and latency/SLO accounting; a
:class:`Workload` owns the device work (``repro_torch.serve.workloads``:
batched NLINV frames, and LM token decode over KV slots).

The lifecycle of one client:

  open()    admission control: admitted up to ``max_concurrency``
            (workload ``open_session`` runs: prefill), queued up to
            ``max_queue`` beyond that, rejected past it.
  submit()  per-session backpressure: at most ``queue_depth`` staged
            work items; a real-time client past the bound has its item
            REJECTED (shed) rather than silently growing latency.
  tick()    batch formation: everything ready this instant, rounded up
            to a bucketed batch width (``buckets``); one
            ``Workload.step`` per tick.
  close()   session teardown (workload ``close_session``: slot free) +
            admission of the next queued client.

``report()`` emits per-client latency statistics through
``latency_stats``, plus the fraction of items inside the budget
(``budget_ms``).

Fault tolerance (``repro_torch.ft``): a *transient* step failure puts
the popped items back at the front of their queues and the next tick
retries them (``step_faults``); a workload may refuse items with
:class:`Rejected` (client quarantine); and ``deadline_ms`` arms the
degradation ladder: sustained breaches lower the workload's operating
point, then the batch-width cap, stepping back up when headroom
returns, every transition logged in ``report()['aggregate']['ft']``.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Any, Optional

from ..nlinv.stream import latency_stats

# Fault-injection hook on the tick boundary (``repro_torch.ft.inject``
# installs it; this module never imports ft).  Called as ``batch =
# STEP_HOOK(workload, batch)`` right before ``Workload.step``: it may
# corrupt per-client items, sleep, or raise a transient failure (the
# tick requeues and retries).  ``None`` (default) is one attribute read.
STEP_HOOK = None


class AdmissionError(RuntimeError):
    """open() past ``max_concurrency`` + ``max_queue``: the service is
    full and the client must back off (the hard admission bound)."""


@dataclasses.dataclass(frozen=True)
class Rejected:
    """Client-visible error status standing in for a frame the service
    refused to deliver (poisoned output, quarantined client).  Appears
    in ``session.results`` so the stream stays frame-aligned; the
    per-client ``poisoned`` counter in ``report()`` tallies them."""

    reason: str


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler policy knobs (one instance per scheduler)."""

    max_concurrency: int = 8        # admitted sessions at once
    max_queue: int = 16             # waiting sessions beyond that
    queue_depth: int = 4            # staged work items per session
    budget_ms: Optional[float] = None   # real-time SLO target per item
    buckets: tuple = (1, 2, 4, 8)   # allowed batch widths (sorted)
    # -- deadline enforcement + graceful degradation ----------------------
    # per-tick wall-clock budget: ``breach_ticks`` consecutive breaches
    # step DOWN the degradation ladder (workload operating points first,
    # then smaller batch-width caps); ``recover_ticks`` consecutive
    # ticks under ``headroom * deadline_ms`` step back UP.  None (the
    # default) disables enforcement entirely.
    deadline_ms: Optional[float] = None
    breach_ticks: int = 3
    recover_ticks: int = 6
    headroom: float = 0.7

    def __post_init__(self):
        if self.max_concurrency < 1:
            raise ValueError("max_concurrency must be >= 1")
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if not self.buckets or list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"buckets must be sorted+nonempty: "
                             f"{self.buckets}")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive (None = off)")
        if self.breach_ticks < 1 or self.recover_ticks < 1:
            raise ValueError("breach_ticks/recover_ticks must be >= 1")
        if not 0.0 < self.headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1]: {self.headroom}")

    def bucket(self, n: int) -> int:
        """Smallest allowed batch width >= n (n capped at the largest)."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]


@dataclasses.dataclass
class Session:
    """One client's stream through the scheduler."""

    sid: int
    client: str
    meta: dict = dataclasses.field(default_factory=dict)
    state: Any = None               # workload-owned (carry / KV slot)
    pending: deque = dataclasses.field(default_factory=deque)
    results: list = dataclasses.field(default_factory=list)
    latency_ms: list = dataclasses.field(default_factory=list)
    rejected: int = 0               # frames shed by backpressure
    poisoned: int = 0               # frames rejected by health checks
    admitted: bool = False
    done: bool = False


class Workload:
    """What the scheduler schedules.  Implementations own all device
    state; the scheduler never touches arrays."""

    # degraded operating points below nominal (0 = none: the default
    # workload cannot trade accuracy for latency, so the deadline ladder
    # falls straight through to smaller batch buckets)
    levels: int = 0

    def open_session(self, session: Session) -> Any:
        """Admission-time setup (carry init / prefill).  The return
        value becomes ``session.state``."""
        raise NotImplementedError

    def set_level(self, level: int) -> None:
        """Switch to degraded operating point ``level`` (0 = nominal;
        called by the scheduler's deadline ladder, only with
        ``level <= self.levels``)."""
        if level != 0:
            raise ValueError(
                f"{type(self).__name__} declares no degraded operating "
                f"points (levels={self.levels})")

    def counters(self) -> dict:
        """Workload-side fault counters merged into
        ``StreamScheduler.report()['aggregate']['ft']`` (retried tasks,
        quarantined clients, ...)."""
        return {}

    def enqueue(self, session: Session, item):
        """Stage one submitted work item (hook for upload-at-enqueue;
        the default stages nothing)."""
        return item

    def step(self, batch: list, width: int) -> list:
        """Run one tick over ``batch`` = [(session, item), ...] with
        ``len(batch) <= width`` (the bucketed launch width).  Returns
        [(result, done), ...] aligned with ``batch``; results must be
        materialized (the scheduler stamps completion time on return).
        """
        raise NotImplementedError

    def close_session(self, session: Session) -> None:
        """Teardown (slot free / carry drop)."""


class StreamScheduler:
    """Continuous batching of N client streams over one Workload."""

    def __init__(self, workload: Workload,
                 config: ServeConfig | None = None):
        self.workload = workload
        self.config = config or ServeConfig()
        self.sessions: dict[int, Session] = {}   # admitted, by sid
        self.waiting: deque[Session] = deque()
        self.closed: list[Session] = []
        self.ticks = 0
        self.tick_ms: list[float] = []
        self._sids = itertools.count()
        # -- fault accounting and degradation-ladder state ---------------
        self.step_faults = 0            # transient tick failures (requeued)
        # ladder rung 0..levels+len(buckets)-1: workload operating points
        # shed accuracy first, then the batch-width cap sheds throughput
        self.rung = 0
        self.events: list[dict] = []    # every ladder transition
        self._breach = self._ok = 0     # consecutive-tick counters

    # -- admission --------------------------------------------------------
    def open(self, client: str = "client", **meta) -> Session:
        """Admit (or queue) one new client stream; raises
        :class:`AdmissionError` when the service is full.

        >>> class Echo(Workload):
        ...     def open_session(self, session): return {}
        ...     def step(self, batch, width):
        ...         return [(item, False) for _, item in batch]
        >>> sched = StreamScheduler(Echo(), ServeConfig(max_concurrency=1,
        ...                                             max_queue=1))
        >>> sched.open("scanner-a").admitted
        True
        >>> sched.open("scanner-b").admitted    # queued behind the first
        False
        >>> sched.open("scanner-c")
        Traceback (most recent call last):
            ...
        repro_torch.serve.scheduler.AdmissionError: service full: 1 admitted, \
1 waiting (max_queue=1)
        """
        if (len(self.sessions) >= self.config.max_concurrency
                and len(self.waiting) >= self.config.max_queue):
            raise AdmissionError(
                f"service full: {len(self.sessions)} admitted, "
                f"{len(self.waiting)} waiting (max_queue="
                f"{self.config.max_queue})")
        s = Session(sid=next(self._sids), client=client, meta=dict(meta))
        if len(self.sessions) < self.config.max_concurrency:
            self._admit(s)
        else:
            self.waiting.append(s)
        return s

    def _admit(self, s: Session) -> None:
        s.state = self.workload.open_session(s)
        s.admitted = True
        self.sessions[s.sid] = s

    def _refill(self) -> None:
        while self.waiting and \
                len(self.sessions) < self.config.max_concurrency:
            self._admit(self.waiting.popleft())

    # -- per-session queueing (backpressure) ------------------------------
    def submit(self, session: Session, item) -> bool:
        """Enqueue one work item (a frame / a decode step).  Returns
        False — the item was SHED — once ``queue_depth`` items are
        already staged: a real-time client must drop frames, not let
        its latency grow without bound.

        >>> class Echo(Workload):
        ...     def open_session(self, session): return {}
        ...     def step(self, batch, width):
        ...         return [(item, False) for _, item in batch]
        >>> sched = StreamScheduler(Echo(), ServeConfig(queue_depth=1))
        >>> s = sched.open("scanner")
        >>> sched.submit(s, "frame0")
        True
        >>> sched.submit(s, "frame1")   # past queue_depth: shed
        False
        >>> s.rejected
        1
        """
        if session.done:
            raise RuntimeError(f"submit on closed session {session.sid}")
        if len(session.pending) >= self.config.queue_depth:
            session.rejected += 1
            return False
        staged = self.workload.enqueue(session, item)
        session.pending.append((staged, time.perf_counter()))
        return True

    # -- the tick ---------------------------------------------------------
    def tick(self) -> int:
        """Admit what fits, batch everything ready, run one Workload
        step.  Returns the number of items completed.

        >>> class Echo(Workload):
        ...     def open_session(self, session): return {}
        ...     def step(self, batch, width):
        ...         return [(item, False) for _, item in batch]
        >>> sched = StreamScheduler(Echo())
        >>> a, b = sched.open("a"), sched.open("b")
        >>> _ = sched.submit(a, 1); _ = sched.submit(b, 2)
        >>> sched.tick()                # one batched step over both
        2
        >>> (a.results, b.results)
        ([1], [2])
        >>> sched.tick()                # nothing ready
        0
        """
        self._refill()
        ready = [s for _, s in sorted(self.sessions.items()) if s.pending]
        if not ready:
            return 0
        cap = self._bucket_cap()
        if len(ready) > cap:
            # overcommitted: rotate the start so no client is starved
            r = self.ticks % len(ready)
            ready = (ready[r:] + ready[:r])[:cap]
        width = self.config.bucket(len(ready))
        batch = [(s, s.pending.popleft()) for s in ready]
        t0 = time.perf_counter()
        try:
            items = [(s, item) for s, (item, _) in batch]
            hook = STEP_HOOK
            if hook is not None:
                items = hook(self.workload, items)
            out = self.workload.step(items, width)
        except Exception as e:
            if not getattr(e, "transient", False):
                raise
            # transient tick failure: nothing was delivered.  Every popped
            # item goes back to the FRONT of its queue (submit order and
            # timestamps kept) and the next tick retries it
            for s, staged in batch:
                s.pending.appendleft(staged)
            self.step_faults += 1
            return 0
        t1 = time.perf_counter()
        self.ticks += 1
        self.tick_ms.append((t1 - t0) * 1e3)
        if len(out) != len(batch):
            raise RuntimeError(
                f"{type(self.workload).__name__}.step returned {len(out)} "
                f"results for a batch of {len(batch)}")
        for (s, (_, t_submit)), (result, done) in zip(batch, out):
            s.results.append(result)
            if isinstance(result, Rejected):
                # a refused frame is an error outcome, not a latency
                # sample: it must not pollute the SLO percentiles
                s.poisoned += 1
            else:
                s.latency_ms.append((t1 - t_submit) * 1e3)
            if done:
                self.close(s)
        if self.config.deadline_ms is not None:
            self._deadline((t1 - t0) * 1e3)
        return len(batch)

    # -- deadline enforcement / degradation ladder ------------------------
    def _bucket_cap(self) -> int:
        """Largest allowed batch width at the current ladder rung."""
        shed = max(self.rung - self.workload.levels, 0)
        return self.config.buckets[
            max(len(self.config.buckets) - 1 - shed, 0)]

    def _max_rung(self) -> int:
        return self.workload.levels + len(self.config.buckets) - 1

    def _deadline(self, ms: float) -> None:
        """Track one tick against the budget; shift the ladder on
        sustained breaches (down) or sustained headroom (up)."""
        cfg = self.config
        if ms > cfg.deadline_ms:
            self._breach += 1
            self._ok = 0
            if self._breach >= cfg.breach_ticks \
                    and self.rung < self._max_rung():
                self._breach = 0
                self._shift(+1, ms)
        else:
            self._breach = 0
            if ms <= cfg.headroom * cfg.deadline_ms:
                self._ok += 1
                if self._ok >= cfg.recover_ticks and self.rung > 0:
                    self._ok = 0
                    self._shift(-1, ms)
            else:
                self._ok = 0

    def _shift(self, direction: int, ms: float) -> None:
        """Move one rung down (+1) or up (-1): workload operating
        points shed accuracy before the bucket cap sheds throughput, so
        recovery restores throughput before accuracy."""
        self.rung += direction
        level = min(self.rung, self.workload.levels)
        if self.workload.levels:
            self.workload.set_level(level)
        self.events.append({
            "tick": self.ticks, "dir": "down" if direction > 0 else "up",
            "rung": self.rung, "op_level": level,
            "bucket_cap": self._bucket_cap(),
            "tick_ms": round(ms, 3)})

    def close(self, session: Session) -> None:
        """End one stream: workload teardown, then admit from the
        waiting queue."""
        if session.done:
            return
        self.workload.close_session(session)
        session.done = True
        session.pending.clear()
        self.sessions.pop(session.sid, None)
        if session in self.waiting:
            self.waiting.remove(session)
        self.closed.append(session)
        self._refill()

    def drain(self) -> int:
        """Tick until no admitted session has work and the waiting
        queue cannot make progress.  Returns items completed."""
        total = 0
        while True:
            n = self.tick()
            total += n
            if n == 0 and not any(s.pending for s in self.sessions.values()):
                self._refill()
                if not any(s.pending for s in self.sessions.values()):
                    return total

    # -- accounting -------------------------------------------------------
    def report(self) -> dict:
        """Per-client latency/SLO table + aggregate throughput, on the
        repo-wide ``latency_stats``."""
        budget = self.config.budget_ms
        clients: dict[str, dict] = {}
        for s in itertools.chain(self.closed, self.waiting,
                                 self.sessions.values()):
            row = {"sid": s.sid, "frames": len(s.latency_ms),
                   "rejected": s.rejected, "poisoned": s.poisoned,
                   **latency_stats(s.latency_ms)}
            if budget is not None:
                inside = sum(1 for t in s.latency_ms if t <= budget)
                row["slo"] = {
                    "budget_ms": budget,
                    "met": round(inside / max(len(s.latency_ms), 1), 3)}
            clients[s.client] = row
        frames = sum(len(s.latency_ms)
                     for s in itertools.chain(self.closed, self.waiting,
                                              self.sessions.values()))
        wall = sum(self.tick_ms)
        # error accounting: "slow" (latency columns) vs "failing" (these)
        ft = {
            "step_faults": self.step_faults,
            "rejected_poisoned": sum(c["poisoned"]
                                     for c in clients.values()),
            "degradation_events": len(self.events),
            "events": list(self.events),
            "rung": self.rung,
            "bucket_cap": self._bucket_cap(),
            **self.workload.counters(),
        }
        return {
            "clients": clients,
            "aggregate": {
                "frames": frames,
                "ticks": self.ticks,
                "tick": latency_stats(self.tick_ms),
                "fps": round(frames / max(wall, 1e-9) * 1e3, 2),
                "rejected": sum(c["rejected"] for c in clients.values()),
                "ft": ft,
            },
        }
