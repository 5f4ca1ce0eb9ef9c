"""Fault tolerance, the port of ``repro.ft``: the restart envelope with
its checkpoint half (``failures``: ``resume_or_init``,
``PreemptionGuard``), the serving path's chaos plane (``inject``) and the
elastic remesh (``remesh``).
"""

from .failures import (PreemptionGuard, RestartPolicy, StragglerWatchdog,
                       resume_or_init, run_with_restarts)
from .inject import (DeviceLossFault, FaultError, FaultInjector, FaultSpec,
                     TransientFault, poison)
from .remesh import migrate_carry, pad_rows

__all__ = ["PreemptionGuard", "RestartPolicy", "StragglerWatchdog",
           "resume_or_init", "run_with_restarts",
           "DeviceLossFault", "FaultError", "FaultInjector", "FaultSpec",
           "TransientFault", "poison",
           "migrate_carry", "pad_rows"]
