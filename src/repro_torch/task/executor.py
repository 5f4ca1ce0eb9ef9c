"""Executing task graphs: dispatch in dependency order, one fence at the
end, and a rolling frame pipeline.

The port of ``repro.task.executor``.  PyTorch's CUDA operations are
asynchronous: a kernel queued on the current stream runs on the card
while the host goes on.  So the executor gets overlap from issue order,
as the JAX package does from its async dispatch: it dispatches every task
of a graph in topological order without synchronizing, and waits only
where the caller needs a finished value.

``Executor``  runs one graph: validate, toposort, dispatch each task,
              record each task's host (dispatch) time in ``trace``.  With
              ``fence=True`` it waits once, at the end, for the device work
              of the values it returns: one CUDA event recorded on the
              current stream of their card, then its ``synchronize()``.
              Values on the CPU need no wait.
``Pipeline``  the rolling form for streams: ``push`` one graph per
              frame or tick; each pushed step records one event, and at
              most ``inflight`` steps stay unfenced: pushing past that
              retires the oldest, which waits on that step's event alone,
              not on the whole card.

>>> g = TaskGraph()
>>> _ = g.add("double", lambda x: 2 * x, inputs=("x",), outputs=("d",))
>>> _ = g.add("inc", lambda d: d + 1, inputs=("d",), outputs=("out",))
>>> Executor().run(g, feeds={"x": 20})
{'d': 40, 'out': 41}
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Mapping, Sequence

import torch

from .graph import TaskGraph

# Fault-injection hook on task dispatch (the port of the JAX package's
# ``ft`` installs it; this module never imports ft).  Called as ``args =
# TASK_HOOK(task, args)`` immediately before ``task.fn(*args)``: it may
# corrupt the args, sleep, or raise.  ``None`` (default) costs one
# attribute read.
TASK_HOOK = None


def _cuda_devices(values) -> list[torch.device]:
    """The CUDA devices of the tensors in ``values`` (nested dicts,
    tuples and lists), in order of first appearance."""
    out: list[torch.device] = []
    stack = [values]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda and v.device not in out:
                out.append(v.device)
        elif isinstance(v, Mapping):
            stack.extend(v.values())
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
    return out


def _record(values) -> list:
    """One CUDA event on the current stream of each card that ``values``
    live on (none for values on the CPU)."""
    events = []
    for dev in _cuda_devices(values):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


def _wait(events) -> None:
    for ev in events:
        ev.synchronize()


@dataclasses.dataclass(frozen=True)
class TaskRun:
    """One dispatched task: host-side cost, not device completion (the
    executor never waits per task: that is the point)."""

    name: str
    kind: str
    host_ms: float
    retries: int = 0    # re-dispatches this run needed (retry policy)


class Executor:
    """Dispatch a :class:`TaskGraph` in dependency order.

    ``run`` returns the produced values.  With ``fence=True`` (default)
    their device work is finished when it returns; ``fence=False`` leaves
    it queued: the :class:`Pipeline` uses that to keep several frames on
    the card's queue at once.

    ``retry`` takes a restart policy: any object with ``max_restarts``,
    ``backoff_s`` and ``backoff_mult`` (the JAX package's
    ``repro.ft.RestartPolicy`` has them).  A task raising a *transient*
    failure (``exc.transient`` truthy, or an instance of ``retryable``) is
    re-dispatched up to ``max_restarts`` times with exponential backoff.
    Dispatch is topo-ordered and host-side, so retrying the failed task
    before anything downstream has been issued re-dispatches its whole
    downstream subgraph against the retried value; other errors propagate
    to the caller.

    >>> g = TaskGraph()
    >>> _ = g.add("one", lambda: 1, outputs=("a",))
    >>> ex = Executor()
    >>> ex.run(g)
    {'a': 1}
    >>> [r.name for r in ex.trace]
    ['one']
    """

    def __init__(self, *, retry=None, retryable=()):
        self.trace: list[TaskRun] = []
        self.retry = retry
        self.retryable = tuple(retryable)
        self.retried = 0    # successful re-dispatches, lifetime

    def _dispatch(self, t, args):
        """One task through the injection hook and the retry envelope."""
        tries = 0
        backoff = getattr(self.retry, "backoff_s", 0.0)
        while True:
            try:
                hook = TASK_HOOK
                a = args if hook is None else hook(t, args)
                return t.fn(*a), tries
            except Exception as e:  # noqa: BLE001 -- the policy decides
                transient = getattr(e, "transient", False) \
                    or isinstance(e, self.retryable)
                if self.retry is None or not transient \
                        or tries >= self.retry.max_restarts:
                    raise
                tries += 1
                self.retried += 1
                if backoff > 0:
                    time.sleep(backoff)
                    backoff *= getattr(self.retry, "backoff_mult", 1.0)

    def run(self, graph: TaskGraph, feeds: Mapping[str, Any] | None = None,
            *, outputs: Sequence[str] | None = None,
            fence: bool = True) -> dict:
        """Execute ``graph`` with ``feeds`` bound to the unproduced value
        names.  Returns every produced value, or only ``outputs`` when
        given.  Raises the graph's validation errors (cycle, missing feed,
        cross-group race) before any task runs."""
        feeds = dict(feeds or {})
        order = graph.toposort(feeds=feeds.keys())
        values = feeds
        for t in order:
            args = [values[v] for v in t.inputs]
            t0 = time.perf_counter()
            res, tries = self._dispatch(t, args)
            self.trace.append(TaskRun(
                t.name, t.kind, (time.perf_counter() - t0) * 1e3,
                retries=tries))
            if len(t.outputs) == 1:
                values[t.outputs[0]] = res
            elif t.outputs:
                if not isinstance(res, (tuple, list)) \
                        or len(res) != len(t.outputs):
                    raise TypeError(
                        f"task {t.name!r} declares {len(t.outputs)} "
                        f"outputs but returned "
                        f"{type(res).__name__}")
                values.update(zip(t.outputs, res))
        produced = {v: values[v] for v in graph.values()}
        out = (produced if outputs is None
               else {v: values[v] for v in outputs})
        if fence:
            _wait(_record(out))
        return out


class Pipeline:
    """Rolling execution of a stream of graphs (one per frame or tick).

    ``push`` dispatches a graph unfenced and returns ``(values,
    retired)``: the step's in-flight values (feed them into the next
    frame's graph: the card's stream orders the work) plus any older
    steps that just left the ``inflight`` window, now finished.  ``flush``
    retires everything left.  The window is the pipeline depth: 1 is the
    fence-every-frame loop, 2 the double-buffered overlap, 3 and more keep
    older frames' later stages queued behind younger frames' earlier ones.
    A step's values stay referenced in the window until it retires, so
    every tensor its tasks read on the card outlives their work.

    >>> pipe = Pipeline(inflight=2)
    >>> g = TaskGraph()
    >>> _ = g.add("inc", lambda x: x + 1, inputs=("x",), outputs=("y",))
    >>> vals, done = pipe.push(g, {"x": 0}, tag="f0")
    >>> vals["y"], done                    # still inside the window
    (1, [])
    >>> for f in range(1, 3):
    ...     vals, done = pipe.push(g, {"x": vals["y"]}, tag=f"f{f}")
    >>> done                               # f0 was forced out and fenced
    [('f0', {'y': 1})]
    >>> [tag for tag, _ in pipe.flush()]
    ['f1', 'f2']

    With ``drop_failed=True`` a step whose dispatch raises is DROPPED:
    recorded in ``dropped`` and ``push`` returns ``(None, [])``, so a
    stream keeps draining past a poisoned frame instead of stalling the
    window; the caller decides what stands in for the lost step.
    """

    def __init__(self, executor: Executor | None = None, *,
                 inflight: int = 2, drop_failed: bool = False):
        if inflight < 1:
            raise ValueError("Pipeline needs inflight >= 1")
        self.executor = executor or Executor()
        self.inflight = inflight
        self.drop_failed = drop_failed
        self.dropped: list[tuple] = []    # (tag, exception) per drop
        self._window: deque = deque()     # (tag, values, events)

    def __len__(self) -> int:
        return len(self._window)

    def push(self, graph: TaskGraph,
             feeds: Mapping[str, Any] | None = None, *,
             tag: Any = None,
             outputs: Sequence[str] | None = None) -> tuple[dict, list]:
        try:
            vals = self.executor.run(graph, feeds, outputs=outputs,
                                     fence=False)
        except Exception as e:  # noqa: BLE001 -- opted in via drop_failed
            if not self.drop_failed:
                raise
            self.dropped.append((tag, e))
            return None, []
        self._window.append((tag, vals, _record(vals)))
        retired = []
        while len(self._window) > self.inflight:
            retired.append(self._retire())
        return vals, retired

    def _retire(self) -> tuple:
        tag, vals, events = self._window.popleft()
        _wait(events)
        return tag, vals

    def flush(self) -> list:
        """Finish and return every step still in the window, oldest
        first."""
        out = []
        while self._window:
            out.append(self._retire())
        return out
