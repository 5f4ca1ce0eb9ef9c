"""Core layer of the port: the paper's contribution (MGPU) on
``torch.distributed``, one process per rank.

Segmented containers (``Policy``, ``SegmentedArray``), device groups
(``DeviceGroup``), the environment that starts a rank (``Environment``)
and the group-bound MPI-like verbs (``Communicator``), the sync family
(``fence``, ``ordered``), the rank launcher (``run_ranks``) and the plan
substrate (``plan``).  The counterpart of the non-deprecated surface of
``repro.core``; its deprecated free-function shims are not ported.
"""

from .env import Communicator, Environment
from .launch import run_ranks
from .runtime import DeviceGroup
from .segmented import Policy, SegmentedArray
from .sync import fence, ordered

__all__ = ["Environment", "Communicator", "DeviceGroup", "Policy",
           "SegmentedArray", "fence", "ordered", "run_ranks"]
