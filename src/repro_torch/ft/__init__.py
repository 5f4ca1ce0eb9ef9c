"""Fault tolerance, the port of ``repro.ft``: the restart envelope
(``failures``), the serving path's chaos plane (``inject``) and the
elastic remesh (``remesh``).

The JAX package's checkpoint half of ``failures`` (``resume_or_init``,
``PreemptionGuard``) calls its checkpoint layer and waits for the port of
that layer (ROADMAP Queue 1, checkpoints).
"""

from .failures import RestartPolicy, StragglerWatchdog, run_with_restarts
from .inject import (DeviceLossFault, FaultError, FaultInjector, FaultSpec,
                     TransientFault, poison)
from .remesh import migrate_carry, pad_rows

__all__ = ["RestartPolicy", "StragglerWatchdog", "run_with_restarts",
           "DeviceLossFault", "FaultError", "FaultInjector", "FaultSpec",
           "TransientFault", "poison",
           "migrate_carry", "pad_rows"]
