"""The serving layer of the port: one scheduler, and the LM workload
behind ``Engine`` (prefill at admission, one greedy decode step a
tick)."""

from .engine import Engine, Request, make_serve_steps
from .scheduler import (AdmissionError, Rejected, ServeConfig, Session,
                        StreamScheduler, Workload)
from .workloads import LMDecodeWorkload, SlotPool

__all__ = [
    "Engine", "Request", "make_serve_steps",
    "AdmissionError", "Rejected", "ServeConfig", "Session",
    "StreamScheduler", "Workload",
    "LMDecodeWorkload", "SlotPool",
]
