"""Fault tolerance: the restart policy and the straggler watchdog.

The port of ``repro/ft/failures.py`` less its checkpoint half
(``resume_or_init``, ``PreemptionGuard``), which comes with the port of
the checkpoint layer.  The launcher's contract: any step may die, and
the loop re-enters with a bounded number of restarts and backoff; a
straggler is detected from step-time statistics and reported (detection
is in-band, replacement is the cluster manager's job).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


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

    The loop reloads its own state; this wrapper only supplies the retry
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
