"""Plan / PlanCache: the library-port substrate (paper §4).

The counterpart of ``repro.core.plan``.  MGPU pairs every library
operation with a *plan*: a descriptor that captures the problem geometry
once and is executed many times.  For a real-time frame loop this is the
difference between per-frame set-up and a steady state where every frame
is a cache hit.

``Plan``       an executable bound to one immutable key; calling it runs
               the program.
``PlanCache``  an LRU-bounded key -> Plan map with hit/miss/eviction
               counters.  ``stats()``/``delta()`` are what the streaming
               engine reports.

Keys that describe tensors hold their shape, dtype and ``torch.device``
(:func:`device_token`), so a plan built for one card never serves
another; keys of segmented operands hold their layout and group
(:func:`seg_token`, :func:`group_token`).  Every ported library (``repro_torch.lib.fft``,
``repro_torch.lib.gridding``) builds its plans through the shared default
cache unless handed a private one.  The two classes live in
``repro_torch.plancache``, under the kernels, whose registry keeps its
block decisions in a ``PlanCache`` too.

>>> cache = PlanCache(maxsize=2)
>>> build = lambda: Plan(key=("square", 3), fn=lambda x: x ** 2)
>>> cache.get_or_build(("square", 3), build)(4)     # miss: builds
16
>>> s = cache.snapshot()
>>> cache.get_or_build(("square", 3), build)(5)     # hit
25
>>> cache.delta(s)["builds"]                        # a steady region
0
>>> device_token("cpu")
'cpu'
"""

from __future__ import annotations

import torch

from ..plancache import Plan, PlanCache  # noqa: F401


def group_token(group=None) -> tuple:
    """Hashable identity of a device group (a ``DeviceGroup`` or a
    ``Communicator``): its backend, its members' global ranks, this
    rank and this rank's device, and the mesh's shape and axes where it
    has more than the one ``"data"`` axis.  Two communicators share plans
    iff they are the same ranks on the same devices in the same mesh,
    the plan-cache form of MGPU plans being bound to their
    ``dev_group``.  ``None`` (no group) keys as ``("nogroup",)``."""
    if group is None:
        return ("nogroup",)
    g = getattr(group, "group", group)
    if not all(hasattr(g, a) for a in ("backend", "ranks", "rank",
                                       "device")):
        raise TypeError(f"not a device group or communicator: {group!r}")
    token = ("group", g.backend, g.ranks, g.rank, device_token(g.device))
    axes = getattr(g, "axes", ("data",))
    return token if axes == ("data",) else token + ((g.shape, axes),)


def seg_token(seg) -> tuple:
    """Hashable layout identity of a SegmentedArray: its global and local
    shapes, dtype and full segmentation policy, and its group."""
    return (tuple(seg.global_shape), tuple(seg.data.shape), str(seg.dtype),
            seg.policy.value, seg.dim, seg.orig_len, seg.block, seg.halo,
            group_token(seg.comm))


def device_token(device) -> str:
    """The device part of a plan key: ``"cuda"`` without an index means
    the current card, so it keys as ``"cuda:<index>"`` like a tensor on
    it."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


_DEFAULT = PlanCache(maxsize=256)


def default_cache() -> PlanCache:
    """The shared cache all ported libraries use unless given their own."""
    return _DEFAULT


def plan_stats() -> dict:
    """Stats of the shared default cache."""
    return _DEFAULT.stats()
