"""``repro_torch.task``: dependency-driven task graphs for frame
pipelining, the port of ``repro.task``.

Declare device work as :class:`Task` nodes (inputs and outputs by name, a
placement hint, explicit ``copy`` transfer edges) in a :class:`TaskGraph`;
run it with :class:`Executor` (dispatch in dependency order, one fence at
the end) or stream per-frame graphs through a :class:`Pipeline` with a
bounded in-flight window.  The NLINV frame program rides it in
``repro_torch.nlinv.stream.FramePipeline``, and one serving tick of the
batched NLINV frame in ``repro_torch.serve.NlinvStreamWorkload``.
"""

from . import executor
from .executor import TASK_HOOK, Executor, Pipeline, TaskRun
from .graph import (CrossGroupError, CycleError, Task, TaskError,
                    TaskGraph, placement_token)

__all__ = [
    "Task", "TaskGraph", "TaskError", "CycleError", "CrossGroupError",
    "placement_token",
    "Executor", "Pipeline", "TaskRun", "TASK_HOOK", "executor",
]
