"""The serving layer of the port: one scheduler for every real-time
workload, ``NlinvStreamWorkload`` (N concurrent MRI streams batched into
one program a tick) and the LM workload behind ``Engine`` (prefill at
admission, one greedy decode step a tick)."""

from .engine import Engine, Request, make_serve_steps
from .scheduler import (AdmissionError, Rejected, ServeConfig, Session,
                        StreamScheduler, Workload)
from .workloads import (LMDecodeWorkload, NlinvStreamWorkload, SlotPool,
                        stack_carries, unstack_carry)

__all__ = [
    "Engine", "Request", "make_serve_steps",
    "AdmissionError", "Rejected", "ServeConfig", "Session",
    "StreamScheduler", "Workload",
    "LMDecodeWorkload", "NlinvStreamWorkload", "SlotPool",
    "stack_carries", "unstack_carry",
]
