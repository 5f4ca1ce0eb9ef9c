"""Core layer of the port: the paper's contribution (MGPU) on
``torch.distributed``, one process per rank.

Segmented containers (``Policy``, ``SegmentedArray``), device groups
as meshes of named axes (``DeviceGroup``, ``DCN_AXES``), the card's
hardware table (``HW``), the environment
that starts a rank (``Environment``) and the group-bound MPI-like verbs
(``Communicator``; ``hierarchical_psum`` and ``ring_allreduce`` on a
rank's tensors), the kernel launchers (``invoke_kernel``,
``invoke_kernel_all``, ``PassThrough``, ``dev_rank``), the sync family
(``fence``, ``ordered``), the rank launcher (``run_ranks``) and the plan
substrate (``plan``).  The counterpart of the non-deprecated surface of
``repro.core``; its deprecated free-function shims are not ported.
"""

from .comm import hierarchical_psum, ring_allreduce
from .env import Communicator, Environment
from .invoke import PassThrough, dev_rank, invoke_kernel, invoke_kernel_all
from .launch import run_ranks
from .runtime import DCN_AXES, HW, DeviceGroup
from .segmented import Policy, SegmentedArray, overlap2d_map
from .sync import fence, ordered

__all__ = ["Environment", "Communicator", "DeviceGroup", "HW", "DCN_AXES",
           "Policy", "SegmentedArray", "overlap2d_map", "hierarchical_psum",
           "ring_allreduce", "invoke_kernel", "invoke_kernel_all",
           "PassThrough", "dev_rank", "fence", "ordered", "run_ranks"]
