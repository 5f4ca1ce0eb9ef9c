"""The NLINV frame solver over a ``Communicator``: the paper's §3.2 coil
split, one process per rank.

``Reconstructor`` is the frame solver ``(y, mask, fov, weight, x0,
x_ref) -> (u, image)``, the counterpart of ``repro.nlinv.recon``'s.  Each
rank runs the shard-local frame on its own coils: the coil data ``y`` and
the coil coefficients ``chat`` are NATURAL-segmented over the
communicator's ranks (over every axis of its group), the image ``rho``
and the acquisition geometry are CLONEd.  The fused DGᴴ channel sum is
``comm.allreduce_overlap`` with the ``<p, Ap>`` scalar in the same
payload, the ``dchat`` branch overlapped, and the ``masked_sum`` kernel
as its local half; the CG residual
partials merge by the vdot policy rule (``rho`` counted once, ``chat``
all-reduced); the RSS readout sums ``|c|²`` across ranks.  Without a
communicator the solver is a 1-rank group on ``device`` (the card unless
``device="cpu"``): the same program with no-op collectives.  Its fused
channel sum is what JAX's psum over one device leaves of the reference's
``allreduce_overlap``: the window written back into zeros.  Where the
FOV is zero outside the window (the dataset's ``fov_mask`` is), that is
the identity, and the frame skips it.

``channel_sum`` strategy:

  full   the whole doubled grid, masked by the whole FOV plane;
  crop   M_Omega zeroes everything outside the centered FOV quarter, so
         only that 2-D window goes on the wire (4x fewer bytes), masked
         by the FOV plane cropped to it, and is scattered back into
         zeros (the paper's ``kern_all_red_p2p_2d`` insight).

The channel sum's product is FOV-supported already, so the ranks'
``masked_sum`` masks by the FOV's 0/1 support, not by its values: both
strategies equal the JAX package's ``allreduce_overlap`` output up to
summation order, for any real FOV.

The fused channel sum's schedule (``core.comm``): by default one
all-gather of the ranks' windows; ``overlap="p2p"`` the ring of ``G - 1``
shifts with the ``dchat`` branch issued after its first round (the
paper's ``kern_all_red_p2p_2d`` schedule; bitwise the default, as both
sum the same stack in rank order); ``hierarchical=True`` the sum staged
over the group's ICI and DCN axes, then masked by the FOV's support (on
a group without both, the default schedule).

``fn_batched(width)`` is the serving layer's frame: B independent
clients' frames solved in one program, a leading client dim on ``y``,
the mask and the carry (the JAX package vmaps its frame), with the
frame kernels taking the batch as one more grid dimension.  Each width
is a plan in ``plan_cache``, so the widths the scheduler buckets to show
up as one build each.  On N ranks the B rows share each collective, as
the JAX package's vmap under ``spmd`` coalesces them: one channel sum
(one all-gather, one ``masked_sum`` launch) for all rows, and one
all-reduce for the B rows' CG residual partials.  ``fused=False`` runs
the unfused solver over the batch the same way: one windowed all-reduce
of the B rows' channel sums, and each scalar product one all-reduce of a
(B,) vector (``comm.vdot(batched=True)``).  Every rank then holds
the same bits of every row's sums, so every rank stops each row's CG at
the same iteration.

Kernel blocks.  The frame's kernels (the ``cg_fused``, ``coil_mult`` and
``masked_allreduce`` families, the JAX package's ``_KERNEL_FAMILIES``)
launch the blocks that the frame resolved before it ran, passed to every
launch (``NlinvOps.blocks``).  The reconstructor makes that choice once
per geometry, the registry's autotuner sweeping each kernel on the card
at the frame's shapes (the ranks of the group taking rank 0's winners):
``init_carry`` and each single frame tune at the frame's shape (a
tune-cache hit after the first) and take the blocks then; ``fn_batched``
tunes at the batch's before it makes the plan's key, which holds the
blocks (``registry.choices_token``), and the plan launches the blocks
of its key: a pin or a new choice builds a new plan, never a stale
one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.env import Communicator
from ..core.plan import Plan, default_cache, group_token
from ..core.runtime import DeviceGroup
from ..core.segmented import Policy
from ..kernels import registry as _kreg
from .irgnm import irgnm, irgnm_fused
from .operators import make_ops, sobolev_weight, uinit

# Segmentation of the unknown pytree u = {rho, chat} (paper §3.2).
U_POLICIES = {"rho": Policy.CLONE, "chat": Policy.NATURAL}

# The same with a leading client dim: the coil split moves to dim 1.
U_POLICIES_BATCHED = {"rho": Policy.CLONE, "chat": (Policy.NATURAL, 1)}

# the kernel families the frame runs; their current blocks are part of the
# batched frame plan's key
_KERNEL_FAMILIES = ("cg_fused", "coil_mult", "masked_allreduce")
# the specs the frame launches, autotuned at its shapes (masked_sum only
# where the channel sum crosses ranks)
_FRAME_SPECS = ("coil_forward", "coil_lincomb", "coil_scale_mult",
                "plane_mult", "coil_adjoint", "cg_update", "xpby")


def _as_communicator(comm, device=None) -> Communicator:
    """comm=None | DeviceGroup | Communicator -> a Communicator; ``None``
    is one rank on ``device`` (the card unless ``"cpu"``)."""
    if comm is None:
        return Communicator.single(device)
    if isinstance(comm, DeviceGroup):
        comm = Communicator(comm)
    if device is not None and torch.device(device).type != comm.device.type:
        raise ValueError(f"device {device} differs from the communicator's "
                         f"{comm.device}")
    return comm


class Reconstructor:
    """One NLINV frame solver on one rank of a Communicator.

    ``fused=True`` (default) runs the hot path (``irgnm_fused`` on the
    CUDA kernels); ``fused=False`` the unfused solver (``channel_sum`` by
    ``comm.allreduce_window``, scalar products by ``comm.vdot``).
    ``impl="plain"`` makes either path use the kernels' plain PyTorch
    versions even on the card (for holding the kernels against them).
    ``overlap`` picks the fused channel sum's schedule: ``"psum"`` (the
    default: one collective) or ``"p2p"`` (the ring of shifts, one-axis
    groups); ``hierarchical=True`` stages it over the ICI and DCN axes
    (and the unfused channel sum too).  ``cg_log`` collects the
    iteration count of every fused CG solve (a tuple of each row's count
    for a batched solve).

    The frame functions take and return this rank's tensors: its coil
    segment of ``y`` and ``chat``, the whole planes and ``rho``; the
    image comes back whole on every rank.
    """

    def __init__(self, comm: Communicator | DeviceGroup | None = None, *,
                 device=None, newton: int = 7, cg_iters: int = 30,
                 channel_sum: str = "crop", fused: bool = True,
                 impl: str = "auto", overlap: str = "psum",
                 hierarchical: bool = False):
        if channel_sum not in ("full", "crop"):
            raise ValueError(f"channel_sum must be full|crop: {channel_sum}")
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be auto|plain: {impl}")
        if overlap not in ("psum", "p2p"):
            raise ValueError(f"overlap must be psum|p2p: {overlap}")
        if overlap == "p2p" and hierarchical:
            raise ValueError("p2p and hierarchical are mutually exclusive "
                             "reduction schedules")
        self.comm = _as_communicator(comm, device)
        self.device = self.comm.device
        self.newton, self.cg_iters = newton, cg_iters
        self.channel_sum, self.fused, self.impl = channel_sum, fused, impl
        self.overlap, self.hierarchical = overlap, hierarchical
        self.cg_log: list = []
        self.plan_cache = default_cache()
        self._geom = None       # (coils of this rank, grid), once seen

    def _tune(self, ncoils: int, grid: int, width=None) -> tuple:
        """Make the frame kernels' current blocks this geometry's: the
        registry's autotuner at the frame's shapes (``width`` rows for the
        batched frame), a sweep on the card the first time, a tune-cache
        hit after; the group's ranks agree.  Nothing to sweep when the
        frame runs its plain versions.  Returns the frame families'
        blocks as ``registry.choices_token`` gives them."""
        self._geom = (int(ncoils), int(grid))
        if self.impl != "plain":
            names = _FRAME_SPECS + (("masked_sum",) if self.comm.size > 1
                                    else ())
            token = ("nlinv", group_token(self.comm), int(ncoils),
                     int(grid), width, self.channel_sum)
            with _kreg.tune_group(self.comm):
                for name in names:
                    _kreg.autotune(name, token=token,
                                   sample=functools.partial(
                                       self._tune_sample, name, int(ncoils),
                                       int(grid), width))
        return _kreg.choices_token(_KERNEL_FAMILIES)

    def _tune_sample(self, name, ncoils, grid, width):
        """Random operands of spec ``name`` at the frame's shapes."""
        spec = _kreg.get(name)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        if name == "masked_sum":
            size = grid // 2 if self.channel_sum == "crop" else grid
            return spec.sample(self.device, gen, nparts=self.comm.size,
                               size=size, width=width), {}
        return spec.sample(self.device, gen, ncoils=ncoils, grid=grid,
                           width=width), {}

    def _ops(self, mask, fov, weight, blocks=()):
        """The frame's operators; ``blocks`` the kernels' (spec id,
        block) pairs of ``_tune``."""
        return make_ops(mask, fov, weight, device=self.device,
                        impl=self.impl, blocks={
                            sid.rsplit(".", 1)[1]: b for sid, b in blocks})

    def _window(self, grid: int):
        """The channel sum's window: the centered FOV quarter with
        ``crop``, the whole grid (``None``) with ``full``."""
        q = grid // 4
        return ((q, 3 * q), (q, 3 * q)) if self.channel_sum == "crop" \
            else None

    def _fused_reducers(self, ops, win):
        """The fused DGᴴ channel sum's hooks ``(reducer, rs_sum)`` for this
        frame's operators; ``(None, None)`` is the identity."""
        comm = self.comm
        if comm.group.pg is None:
            # one rank: the reference's psum is the identity, its
            # scatter back into zeros is not, unless the FOV-supported
            # product is already zero outside the window
            if win is None:
                return None, None
            idx = (..., slice(*win[0]), slice(*win[1]))
            outside = ops.fov.clone()
            outside[idx] = 0
            if not bool(outside.any()):
                return None, None

            def crop(prod, extras, compute):
                out = compute() if compute is not None else None
                red = torch.zeros_like(prod)
                red[idx] = prod[idx]
                return red, tuple(extras), out

            return crop, None
        # the product carries the FOV's values already: mask the sum by
        # the FOV's support only
        support = (ops.fov != 0).to(torch.float32)
        m = support if win is None else \
            support[slice(*win[0]), slice(*win[1])].contiguous()

        def reducer(prod, extras, compute):
            return comm.allreduce_overlap(prod, win, extras=extras,
                                          compute=compute, mask=m,
                                          p2p=self.overlap == "p2p",
                                          hierarchical=self.hierarchical,
                                          impl=self.impl,
                                          block=ops.blocks.get("masked_sum"))

        def rs_sum(parts):
            return parts["rho"] + comm.allreduce(parts["chat"])

        return reducer, rs_sum

    def _solve(self, ops, y, x0, x_ref, newton, cg_iters):
        """The Newton/CG solve over this frame's operators, or over a
        batch of frames (``ops.batched``)."""
        win = self._window(ops.fov.shape[-1])
        if self.fused:
            reducer, rs_sum = self._fused_reducers(ops, win)
            return irgnm_fused(ops, y, x0, x_ref, newton=newton,
                               cg_iters=cg_iters, reducer=reducer,
                               rs_sum=rs_sum, log=self.cg_log)
        comm, batched = self.comm, ops.batched
        policies = U_POLICIES_BATCHED if batched else U_POLICIES

        def csum(prod):
            # the coils are dim 1 of a batch, and its B rows' windows
            # share one collective
            return comm.allreduce_window(prod, win,
                                         reduce_dim=1 if batched else 0,
                                         hierarchical=self.hierarchical)

        def dot(a, b):
            return comm.vdot(a, b, policies=policies, batched=batched)

        return irgnm(ops, y, x0, x_ref, newton=newton, cg_iters=cg_iters,
                     channel_sum=csum, dot=dot)

    def _frame_solve(self, y, mask, fov, weight, x0, x_ref):
        """Newton/CG stage only: acquisition -> solved ``u``, its kernels
        at the blocks tuned for this frame's geometry."""
        blocks = self._tune(y.shape[0], y.shape[-1])
        return self._solve(self._ops(mask, fov, weight, blocks), y, x0,
                           x_ref, self.newton, self.cg_iters)

    def _frame_image(self, mask, fov, weight, u):
        """Readout stage: solved ``u`` -> displayed image (the
        root-sum-of-squares channel combination, summed across ranks)."""
        ops = self._ops(mask, fov, weight)
        c = ops.coils(u["chat"])
        rss = self.comm.allreduce_window(torch.abs(c) ** 2, None,
                                         reduce_dim=0)
        return u["rho"] * torch.sqrt(rss)

    def _frame(self, y, mask, fov, weight, x0, x_ref):
        u = self._frame_solve(y, mask, fov, weight, x0, x_ref)
        return u, self._frame_image(mask, fov, weight, u)

    def _frame_donate(self, y, mask, fov, weight, x0, x_ref):
        """``_frame`` that writes the new ``u`` into ``x0``'s tensors, in
        place, and returns them: the carry's buffers are reused frame to
        frame (the JAX package donates them)."""
        u, img = self._frame(y, mask, fov, weight, x0, x_ref)
        for k in x0:
            x0[k].copy_(u[k])
        return x0, img

    @property
    def fn(self):
        return self._frame

    @property
    def fn_donate_carry(self):
        """The frame function that overwrites ``x0`` in place with the new
        ``u``; the caller must not rely on ``x0``'s old values after it."""
        return self._frame_donate

    @property
    def fn_solve(self):
        return self._frame_solve

    @property
    def fn_image(self):
        return self._frame_image

    def __call__(self, y, mask, fov, weight, x0, x_ref):
        return self.fn(y, mask, fov, weight, x0, x_ref)

    # -- the batched frame (serving layer: B clients, one program) --------
    def _frame_batched(self, width, newton, cg_iters, donate, blocks, y,
                       mask, fov, weight, x0, x_ref):
        """B = ``width`` independent frames: ``y`` (B, J, X, Y), ``mask``
        (B, X, Y), the carry {rho (B, X, Y), chat (B, J, X, Y)}, ``fov``
        and ``weight`` shared; ``y`` and ``chat`` are this rank's coils.
        The solve, fused or not, runs every row at once through the
        batched kernels and collectives (each row's CG stops on its own,
        the unfused CG steered by one scalar product a row); the readout
        runs row by row through ``_frame_image``, so a row's image is the
        unbatched frame's.  With ``donate`` the new ``u`` is written into ``x0``'s
        tensors.  ``blocks``: the kernels' (spec id, block) pairs of the
        plan's key."""
        if y.ndim != 4 or y.shape[0] != width or \
                tuple(mask.shape) != (width, *y.shape[-2:]):
            raise ValueError(f"batched frame of width {width}: y "
                             f"{tuple(y.shape)}, mask {tuple(mask.shape)}")
        u = self._solve(self._ops(mask, fov, weight, blocks), y, x0, x_ref,
                        newton, cg_iters)
        img = torch.stack([
            self._frame_image(mask[b], fov, weight,
                              {k: v[b] for k, v in u.items()})
            for b in range(width)])
        if donate:
            for k in x0:
                x0[k].copy_(u[k])
            u = x0
        return u, img

    def _plan_batched(self, width: int, donate: bool) -> Plan:
        """The batched frame of one width as a plan, keyed as the JAX
        package keys its compiled program: the width and the solver's
        configuration, so that the scheduler's buckets show up as one
        build each and a set_level of the Newton/CG depth a plan each.
        The key carries the group's token, so a survivor group after a
        remesh builds plans of its own, the channel sum's schedule and
        the solver's form (``fused``), and the frame kernels' blocks, as
        the JAX package's key does: they are tuned at this width first,
        where the frame's geometry is known (``init_carry``, or an earlier
        frame).  The plan launches the blocks of its key, whatever the
        choices are when it runs."""
        width = int(width)
        blocks = self._tune(*self._geom, width=width) \
            if self._geom is not None else \
            _kreg.choices_token(_KERNEL_FAMILIES)
        key = ("nlinv", "frame_batched", group_token(self.comm), width,
               self.newton, self.cg_iters, self.channel_sum,
               self.hierarchical, self.fused, self.overlap, self.impl,
               bool(donate), blocks)
        newton, cg_iters = self.newton, self.cg_iters

        def build():
            # the plan takes the reconstructor that calls it: any with
            # this key runs the same program, and logs into its own cg_log
            def fn(rec, *args):
                return rec._frame_batched(width, newton, cg_iters,
                                          bool(donate), blocks, *args)
            return Plan(key=key, fn=fn, lib="nlinv", op="frame_batched",
                        meta={"kernel_blocks": dict(blocks)})

        return self.plan_cache.get_or_build(key, build)

    def fn_batched(self, width: int, *, donate: bool = False):
        """The B-client frame for batch width ``width``: ``(y (B,J,X,Y),
        mask (B,X,Y), fov, weight, u (B,...), x_ref (B,...)) -> (u, images
        (B,X,Y))``.  Plan-cached per width; ``donate`` overwrites ``u``'s
        tensors in place with the new carry."""
        return functools.partial(self._plan_batched(width, donate).fn, self)

    # -- carry/constant placement through the verbs -----------------------
    def init_carry(self, ncoils: int, grid: int):
        """This rank's Newton carry: rho = 1 (CLONE), its segment of
        chat = 0 (NATURAL: ``ncoils`` padded to a multiple of the group
        size).  The frame's kernels are tuned at this geometry here."""
        per = -(-ncoils // self.comm.size)
        self._tune(per, grid)
        return uinit(per, grid, device=self.device)

    def put_frame(self, y):
        """This rank's coils of one frame (J, X, Y) as complex64 on its
        device; from numpy, only those coils are uploaded (page-locked
        and asynchronous on the card)."""
        return self.comm.container(y, policy=Policy.NATURAL,
                                   dtype=torch.complex64).data

    def put_const(self, x):
        """A per-frame real plane (mask / fov / weight), whole on every
        rank, as float32."""
        return self.comm.container(x, policy=Policy.CLONE,
                                   dtype=torch.float32).data


def reconstruct_frame(y, mask, fov, weight, x0, x_ref, *, newton=7,
                      cg_iters=30, device=None):
    """One NLINV frame on one device; ``y`` (J, X, Y) and the planes may
    be numpy arrays or tensors."""
    rec = Reconstructor(device=device, newton=newton, cg_iters=cg_iters,
                        channel_sum="full")

    def put(a, how):
        return a.to(rec.device) if isinstance(a, torch.Tensor) else how(a)

    return rec(put(y, rec.put_frame), put(mask, rec.put_const),
               put(fov, rec.put_const), put(weight, rec.put_const), x0, x_ref)


def make_dist_reconstruct(comm, *, newton=7, cg_iters=30,
                          channel_sum="crop", fused=True):
    """The distributed NLINV frame over global inputs (paper §3.2): every
    rank passes the same ``(y, mask, fov, weight, x0, x_ref)`` (numpy or
    tensors; ``x0``/``x_ref`` dicts {rho, chat}), keeps its coils and
    returns ``(u, image)`` as containers (``U_POLICIES`` and CLONE).
    ``comm`` is a Communicator or a DeviceGroup."""
    rec = Reconstructor(comm, newton=newton, cg_iters=cg_iters,
                        channel_sum=channel_sum, fused=fused)
    clone = Policy.CLONE
    return rec.comm.spmd(rec._frame,
                         in_policies=(Policy.NATURAL, clone, clone, clone,
                                      U_POLICIES, U_POLICIES),
                         out_policies=(U_POLICIES, clone))


def pad_channels(y, nseg, axis: int = 0):
    """Zero-pad the coil dim to a multiple of the group size (zero
    channels are exact no-ops for all NLINV sums)."""
    J = y.shape[axis]
    Jp = -(-J // nseg) * nseg
    if Jp == J:
        return y
    pad = np.zeros(y.shape[:axis] + (Jp - J,) + y.shape[axis + 1:], y.dtype)
    return np.concatenate([y, pad], axis=axis)


def reconstruct_movie(data, *, newton=7, cg_iters=30, damping=0.9,
                      device=None):
    """Blocking sequential movie loop (frames depend on x_ref, paper
    §3.2).  Returns (F, X, Y) images; ``FrameStream`` is the
    transfer-overlapped engine."""
    rec = Reconstructor(device=device, newton=newton, cg_iters=cg_iters,
                        channel_sum="full")
    y, masks, fov = data["y"], data["masks"], data["fov"]
    F, J, g, _ = y.shape
    fov_d = rec.put_const(fov)
    w_d = rec.put_const(sobolev_weight(g))
    u = rec.init_carry(J, g)
    x_ref = u
    images = []
    for f in range(F):
        u, img = rec(rec.put_frame(y[f]), rec.put_const(masks[f]), fov_d,
                     w_d, u, x_ref)
        x_ref = {k: damping * v for k, v in u.items()}
        images.append(img)
    return torch.stack(images)
