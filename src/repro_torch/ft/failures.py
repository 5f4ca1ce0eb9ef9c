"""Fault tolerance: restart policy, preemption flush, straggler watchdog.

The port of ``repro/ft/failures.py``.  The launcher's contract: (1) any
step may die, and the loop re-enters with a bounded number of restarts
and backoff, resuming from the last complete checkpoint
(``resume_or_init``) with bounded lost work; (2) a preemption signal
flushes a checkpoint before exit (``PreemptionGuard``); (3) a straggler
is detected from step-time statistics and reported (detection is
in-band, replacement is the cluster manager's job).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

from ..ckpt import latest_step, restore_sharded, save


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0


def run_with_restarts(train_loop: Callable[[int], int], *,
                      policy: Optional[RestartPolicy] = None,
                      on_restart: Optional[Callable[[int, Exception], None]]
                      = None) -> int:
    """``train_loop(start_step) -> final_step``; re-enter after failures.

    The loop reloads its own state from the checkpoint dir
    (:func:`resume_or_init`); this wrapper only supplies the retry
    envelope.
    """
    # a fresh default per call: RestartPolicy is a mutable dataclass, so
    # a default instance in the signature would be shared by every caller
    policy = RestartPolicy() if policy is None else policy
    restarts = 0
    backoff = policy.backoff_s
    last_step = 0
    while True:
        try:
            return train_loop(last_step)
        except Exception as e:  # noqa: BLE001 -- any step failure
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            if on_restart:
                on_restart(restarts, e)
            time.sleep(backoff)
            backoff *= policy.backoff_mult


def resume_or_init(ckpt_dir, tree_like, placements, init_fn):
    """The latest checkpoint placed by ``placements`` (see
    ``ckpt.restore_sharded``) if there is one, else ``init_fn()`` (a cold
    start).  Returns (tree, step)."""
    if latest_step(ckpt_dir) is not None:
        return restore_sharded(ckpt_dir, tree_like, placements)
    return init_fn(), 0


class PreemptionGuard:
    """SIGTERM -> flush a final checkpoint before the scheduler kills us.

    Installs its handler when made (from the main thread); :meth:`close`
    puts the old one back, so that a process that goes on after the loop
    (a test worker) is not left ignoring SIGTERM."""

    def __init__(self):
        self.preempted = False
        self._orig = signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, signum, frame):
        self.preempted = True

    def maybe_flush(self, ckpt_dir, step, state) -> bool:
        if self.preempted:
            save(ckpt_dir, step, state, blocking=True)
            return True
        return False

    def close(self) -> None:
        signal.signal(signal.SIGTERM, self._orig)


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the rolling median.

    The real-time constraint (bounded per-frame latency) is the same
    contract: a straggling rank shows up as a slow collective for every
    rank, so wall-clock per step is the signal.
    """
    threshold: float = 2.0
    window: int = 50
    _times: list = dataclasses.field(default_factory=list)
    flagged: int = 0

    def record(self, step_time: float) -> bool:
        times = sorted(self._times[-self.window:])
        slow = bool(times) and len(times) >= 5 and \
            step_time > self.threshold * times[len(times) // 2]
        self._times.append(step_time)
        if slow:
            self.flagged += 1
        return slow

    @property
    def median(self) -> float:
        t = sorted(self._times[-self.window:])
        return t[len(t) // 2] if t else 0.0
