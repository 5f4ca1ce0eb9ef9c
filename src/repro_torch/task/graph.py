"""Dependency-driven task graphs over the port's ``Communicator``.

The port of ``repro.task.graph``, whole: it is pure Python.  The 2017
follow-up of the paper (Schaetz et al., arXiv:1701.08361 §3) runs the
reconstruction as a multi-stage pipeline, in which the upload, the
Newton/CG solve and the readout of different frames are in flight at
once; tasks that declare their data dependencies and a placement hint are
the abstraction for it:

``Task``       one unit of device (or host) work: a callable plus the
               *names* of the values it consumes and produces, a
               placement hint (the ``Communicator``/group it runs on)
               and a kind (``compute`` or ``copy``, the explicit
               transfer edges).
``TaskGraph``  the dependency graph.  Construction validates producer
               uniqueness; ``toposort`` orders ready tasks and raises
               :class:`CycleError` on cycles; ``validate`` raises
               :class:`CrossGroupError` when a value produced on one
               device group is consumed on a *different* group without
               an explicit ``copy`` edge in between (a cross-group data
               race: the bytes would never move).

Graphs are cheap, pure-Python descriptions: build one per frame (or per
tick) and hand it to :class:`repro_torch.task.Executor`.

>>> g = TaskGraph()
>>> t = g.add("scale", lambda x: [2 * v for v in x],
...           inputs=("raw",), outputs=("scaled",))
>>> g.add("total", sum, inputs=("scaled",), outputs=("out",))
Task('total', inputs=('scaled',), outputs=('out',))
>>> [t.name for t in g.toposort(feeds=("raw",))]
['scale', 'total']
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Sequence

from ..core.plan import group_token


class TaskError(RuntimeError):
    """Base class for task-graph construction/validation errors."""


class CycleError(TaskError):
    """The graph has a dependency cycle (named in the message)."""


class CrossGroupError(TaskError):
    """A value produced on one device group is consumed on another
    without an explicit ``copy`` edge — a cross-group data race."""


def placement_token(group) -> tuple | None:
    """Hashable placement identity of ``group`` (a Communicator,
    DeviceGroup or None).  Two hints collide iff they are the same ranks
    on the same devices: the identity plans key on
    (:func:`repro_torch.core.plan.group_token`)."""
    return None if group is None else group_token(group)


@dataclasses.dataclass(frozen=True)
class Task:
    """One node: ``fn`` consuming ``inputs`` and producing ``outputs``.

    ``group`` is the placement hint (where the work runs); ``kind`` is
    ``"compute"`` for ordinary work and ``"copy"`` for explicit
    transfer edges (verb calls, host-to-device staging): the only tasks
    allowed to bridge device groups.
    """

    name: str
    fn: Callable
    inputs: tuple[str, ...] = ()
    outputs: tuple[str, ...] = ()
    group: Any = None
    kind: str = "compute"

    def __post_init__(self):
        if self.kind not in ("compute", "copy"):
            raise TaskError(f"task {self.name!r}: kind must be "
                            f"compute|copy, got {self.kind!r}")

    @property
    def placement(self) -> tuple | None:
        return placement_token(self.group)

    def __repr__(self) -> str:
        return (f"Task({self.name!r}, inputs={self.inputs}, "
                f"outputs={self.outputs})")


class TaskGraph:
    """A dependency graph of named tasks over named values.

    Tasks communicate through *value names*: a task runs once every
    input name is produced (or supplied as a feed at execution time).
    Each value has exactly one producer; adding a second raises.

    >>> g = TaskGraph()
    >>> g.add("a", lambda: 1, outputs=("x",))
    Task('a', inputs=(), outputs=('x',))
    >>> g.add("b", lambda x: x + 1, inputs=("x",), outputs=("y",))
    Task('b', inputs=('x',), outputs=('y',))
    >>> g.add("again", lambda: 2, outputs=("x",))
    Traceback (most recent call last):
        ...
    repro_torch.task.graph.TaskError: value 'x' already produced by task 'a'
    """

    def __init__(self):
        self._tasks: dict[str, Task] = {}
        self._producer: dict[str, str] = {}   # value name -> task name

    # -- construction -----------------------------------------------------
    def add(self, name: str, fn: Callable, *, inputs: Sequence[str] = (),
            outputs: Sequence[str] = (), group: Any = None,
            kind: str = "compute") -> Task:
        """Add one task.  ``fn`` is called as ``fn(*input_values)`` and
        must return one value per output name (a tuple when there are
        several).  ``group`` is the placement hint."""
        if name in self._tasks:
            raise TaskError(f"duplicate task name {name!r}")
        t = Task(name=name, fn=fn, inputs=tuple(inputs),
                 outputs=tuple(outputs), group=group, kind=kind)
        for v in t.outputs:
            if v in self._producer:
                raise TaskError(f"value {v!r} already produced by task "
                                f"{self._producer[v]!r}")
        # commit only after full validation so a failed add is a no-op
        self._tasks[name] = t
        for v in t.outputs:
            self._producer[v] = name
        return t

    def copy(self, name: str, fn: Callable, *, inputs: Sequence[str] = (),
             outputs: Sequence[str] = (), group: Any = None) -> Task:
        """Add an explicit transfer edge (``kind="copy"``): a verb call
        or host-to-device staging step.  Copy tasks are the only ones
        allowed to consume values placed on a different group."""
        return self.add(name, fn, inputs=inputs, outputs=outputs,
                        group=group, kind="copy")

    # -- queries ----------------------------------------------------------
    @property
    def tasks(self) -> tuple[Task, ...]:
        return tuple(self._tasks.values())

    def __len__(self) -> int:
        return len(self._tasks)

    def __contains__(self, name: str) -> bool:
        return name in self._tasks

    def task(self, name: str) -> Task:
        return self._tasks[name]

    def producer(self, value: str) -> Task | None:
        """The task producing ``value`` (None: it must be a feed)."""
        name = self._producer.get(value)
        return None if name is None else self._tasks[name]

    def values(self) -> tuple[str, ...]:
        """Every value name produced by some task."""
        return tuple(self._producer)

    def __repr__(self) -> str:
        return (f"TaskGraph({len(self._tasks)} tasks, "
                f"{len(self._producer)} values)")

    # -- validation -------------------------------------------------------
    def validate(self, feeds: Iterable[str] = ()) -> None:
        """Raise loudly on the graph's failure modes:

        * an input neither produced nor fed (:class:`TaskError`),
        * a dependency cycle (:class:`CycleError`),
        * a cross-group consume without a ``copy`` edge
          (:class:`CrossGroupError`).
        """
        feeds = set(feeds)
        for t in self._tasks.values():
            for v in t.inputs:
                if v not in self._producer and v not in feeds:
                    raise TaskError(
                        f"task {t.name!r} consumes {v!r}, which no task "
                        f"produces and no feed supplies")
        self._check_cross_group()
        self.toposort(feeds=feeds, _validate=False)

    def _check_cross_group(self) -> None:
        for t in self._tasks.values():
            if t.kind == "copy" or t.placement is None:
                continue
            for v in t.inputs:
                p = self.producer(v)
                if p is None or p.kind == "copy" or p.placement is None:
                    continue
                if p.placement != t.placement:
                    raise CrossGroupError(
                        f"value {v!r} is produced by task {p.name!r} on "
                        f"one device group but consumed by task "
                        f"{t.name!r} on a different one: route it "
                        f"through an explicit copy/verb edge "
                        f"(TaskGraph.copy)")

    def toposort(self, feeds: Iterable[str] = (), *,
                 _validate: bool = True) -> tuple[Task, ...]:
        """Dependency order (Kahn's algorithm).  Ties break by insertion
        order, so independent tasks of *older* pipeline stages issue
        first.  Raises :class:`CycleError` naming the cycle.

        >>> g = TaskGraph()
        >>> _ = g.add("a", lambda x: x, inputs=("b_out",), outputs=("a_out",))
        >>> _ = g.add("b", lambda x: x, inputs=("a_out",), outputs=("b_out",))
        >>> g.toposort()
        Traceback (most recent call last):
            ...
        repro_torch.task.graph.CycleError: dependency cycle: a -> b -> a
        """
        if _validate:
            self.validate(feeds)
            return self.toposort(feeds, _validate=False)
        feeds = set(feeds)
        # in-degree = number of inputs produced by a not-yet-run task
        deps = {t.name: {self._producer[v] for v in t.inputs
                         if v in self._producer}
                for t in self._tasks.values()}
        order, ready = [], [n for n, d in deps.items() if not d]
        done: set[str] = set()
        while ready:
            name = ready.pop(0)
            done.add(name)
            order.append(self._tasks[name])
            ready += [n for n, d in deps.items()
                      if n not in done and n not in ready
                      and d <= done]
        if len(order) != len(self._tasks):
            raise CycleError("dependency cycle: "
                             + " -> ".join(self._find_cycle(deps, done)))
        return tuple(order)

    def _find_cycle(self, deps: dict, done: set) -> list[str]:
        """Walk producer edges from any unordered task until a repeat."""
        start = next(n for n in self._tasks if n not in done)
        seen, path = {}, []
        node = start
        while node not in seen:
            seen[node] = len(path)
            path.append(node)
            node = next(iter(n for n in sorted(deps[node])
                             if n not in done))
        return path[seen[node]:] + [node]
