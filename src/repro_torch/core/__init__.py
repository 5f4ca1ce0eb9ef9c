"""Core layer of the port: the paper's contribution (MGPU) on
``torch.distributed``, one process per rank.

Segmented containers (``Policy``, ``SegmentedArray``), device groups
as meshes of named axes (``DeviceGroup``, ``DCN_AXES``), the card's
hardware table (``HW``), the environment
that starts a rank (``Environment``) and the group-bound MPI-like verbs
(``Communicator``; ``hierarchical_psum`` and ``ring_allreduce`` on a
rank's tensors), the kernel launchers' helpers (``PassThrough``,
``dev_rank``), the sync family (``fence``, ``ordered``), the rank
launcher (``run_ranks``) and the plan substrate (``plan``).  The
counterpart of ``repro.core``.

The stable surface is object-oriented: a ``Communicator``'s methods are
the verbs.  The free functions below (``segment``/``broadcast``/
``all_reduce``/...) are the pre-Communicator surface of the JAX package,
kept as thin deprecated shims: each takes the JAX free function's
arguments, calls the port's ``Communicator`` method or container verb,
warns ``DeprecationWarning`` and names its replacement in
``__deprecated__``.  A group argument left ``None`` is the default
group (``current_group``): every rank of the default process group.  No
module of the port calls them.
"""

import functools as _functools
import warnings as _warnings

from . import comm as _comm
from .comm import hierarchical_psum, ring_allreduce
from .env import Communicator, Environment
from .invoke import PassThrough, dev_rank
from .launch import run_ranks
from .runtime import DCN_AXES, HW, DeviceGroup
from .segmented import Policy, SegmentedArray
from .sync import fence, ordered


def _deprecated(fn, name: str, replacement: str):
    """Wrap a free-function verb as a deprecation shim (same signature)."""
    @_functools.wraps(fn)
    def shim(*args, **kw):
        _warnings.warn(
            f"repro_torch.core.{name} is deprecated; use {replacement}",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kw)
    shim.__deprecated__ = replacement
    return shim


def _current_group(group=None) -> DeviceGroup:
    """Default-group resolution: the explicit group (or a Communicator's)
    when given, else every rank of the default process group (one rank on
    the card when none is initialized)."""
    if group is not None:
        return getattr(group, "group", group)
    return DeviceGroup.all_devices()


def _comm_of(group=None) -> Communicator:
    if isinstance(group, Communicator):
        return group
    return Communicator(_current_group(group))


def _owner(seg, name: str) -> Communicator:
    if not isinstance(seg, SegmentedArray):
        raise TypeError(f"{name} takes a SegmentedArray, got "
                        f"{type(seg).__name__}")
    return seg.comm


def _segment(x, group=None, *, policy: Policy = Policy.NATURAL,
             dim: int = 0, block: int | None = None, halo: int = 0,
             dtype=None) -> SegmentedArray:
    return _comm_of(group).container(x, policy=policy, dim=dim, block=block,
                                     halo=halo, dtype=dtype)


def _gather(seg):
    return _owner(seg, "gather").gather(seg)


def _overlap2d_map(seg, fn):
    _owner(seg, "overlap2d_map")
    return seg.halo_exchange(fn)


def _broadcast(x, group=None, *, src: int = 0) -> SegmentedArray:
    return _comm_of(group).bcast(x, src=src)


def _scatter(x, group=None, *, policy: Policy = Policy.NATURAL,
             dim: int = 0, block: int | None = None, halo: int = 0,
             src: int = 0) -> SegmentedArray:
    return _comm_of(group).scatter(x, policy=policy, dim=dim, block=block,
                                   halo=halo, src=src)


def _reduce(seg, op: str = "sum"):
    return _owner(seg, "reduce").reduce(seg, op)


def _all_reduce(seg, op: str = "sum", hierarchical: bool = False,
                p2p: bool = False):
    return _owner(seg, "all_reduce").allreduce(
        seg, op, hierarchical=hierarchical, p2p=p2p)


def _all_reduce_window(x, window=None, *, op: str = "sum",
                       reduce_dim: int | None = None,
                       hierarchical: bool = False, window_axes=None,
                       p2p: bool = False, group=None):
    comm = x.comm if isinstance(x, SegmentedArray) and group is None \
        else _comm_of(group)
    return comm.allreduce_window(x, window, op=op, reduce_dim=reduce_dim,
                                 hierarchical=hierarchical,
                                 window_axes=window_axes, p2p=p2p)


def _vdot(x, y, *, policies=None, group=None):
    seg = next((v for v in _comm._leaves(x)
                if isinstance(v, SegmentedArray)), None)
    comm = seg.comm if seg is not None and group is None \
        else _comm_of(group)
    return comm.vdot(x, y, policies=policies)


def _copy(src, *, policy: Policy | None = None, **kw):
    return _owner(src, "copy").copy(src, policy=policy, **kw)


def _all_to_all(seg, new_dim: int):
    return _owner(seg, "all_to_all").alltoall(seg, new_dim)


def _reduce_scatter(seg, op: str = "sum"):
    return _owner(seg, "reduce_scatter").reduce_scatter(seg, op)


def _invoke_kernel(fn, *args, rank: int, group=None, **kw):
    return _comm_of(group).invoke(fn, *args, rank=rank, **kw)


def _invoke_kernel_all(fn, *args, group=None, out_policy=Policy.NATURAL,
                       out_dim: int = 0):
    return _comm_of(group).invoke_all(fn, *args, out_policy=out_policy,
                                      out_dim=out_dim)


def _make_spmd(fn, group=None, *, in_policies, out_policies):
    return _comm_of(group).spmd(fn, in_policies=in_policies,
                                out_policies=out_policies)


def _barrier(group=None) -> None:
    _comm_of(group).barrier()


def _barrier_fence(*tensors, group=None):
    return _comm_of(group).barrier_fence(*tensors)


# -- deprecated free-function surface (pre-Communicator API) ---------------
current_group = _deprecated(_current_group, "current_group",
                            "an explicit Environment()/Communicator")
segment = _deprecated(_segment, "segment", "Communicator.container")
gather = _deprecated(_gather, "gather",
                     "Communicator.gather / SegmentedArray.gather")
overlap2d_map = _deprecated(_overlap2d_map, "overlap2d_map",
                            "SegmentedArray.halo_exchange")
broadcast = _deprecated(_broadcast, "broadcast", "Communicator.bcast")
scatter = _deprecated(_scatter, "scatter", "Communicator.scatter")
reduce = _deprecated(_reduce, "reduce", "Communicator.reduce")
all_reduce = _deprecated(_all_reduce, "all_reduce",
                         "Communicator.allreduce")
all_reduce_window = _deprecated(_all_reduce_window, "all_reduce_window",
                                "Communicator.allreduce_window")
vdot = _deprecated(_vdot, "vdot", "Communicator.vdot")
copy = _deprecated(_copy, "copy", "Communicator.copy / SegmentedArray.to")
all_to_all = _deprecated(_all_to_all, "all_to_all", "Communicator.alltoall")
reduce_scatter = _deprecated(_reduce_scatter, "reduce_scatter",
                             "Communicator.reduce_scatter")
invoke_kernel = _deprecated(_invoke_kernel, "invoke_kernel",
                            "Communicator.invoke")
invoke_kernel_all = _deprecated(_invoke_kernel_all, "invoke_kernel_all",
                                "Communicator.invoke_all")
make_spmd = _deprecated(_make_spmd, "make_spmd", "Communicator.spmd")
barrier = _deprecated(_barrier, "barrier", "Communicator.barrier")
barrier_fence = _deprecated(_barrier_fence, "barrier_fence",
                            "Communicator.barrier_fence")

__all__ = [
    "Environment", "Communicator",
    "DeviceGroup", "current_group", "HW", "DCN_AXES",
    "Policy", "SegmentedArray", "segment", "gather", "overlap2d_map",
    "broadcast", "scatter", "reduce", "all_reduce", "all_reduce_window",
    "vdot", "copy", "all_to_all", "reduce_scatter", "hierarchical_psum",
    "ring_allreduce",
    "invoke_kernel", "invoke_kernel_all", "make_spmd", "PassThrough",
    "dev_rank",
    "fence", "barrier", "barrier_fence", "ordered", "run_ranks",
]
