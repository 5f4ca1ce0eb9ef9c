"""The two workloads behind ``StreamScheduler``, the port of
``repro/serve/workloads.py``.

:class:`NlinvStreamWorkload` serves N concurrent real-time NLINV streams:
the independent clients' frames are stacked on a leading batch dim of the
``(rho, chat)`` carry and solved in ONE batched program
(``Reconstructor.fn_batched``), whose frame kernels take the clients as
one more grid dimension.  Two invariants keep the tick cheap:

  * the stacked carry is PERSISTENT: while the ready set is stable (K
    clients streaming) it stays on the card and is updated in place; it
    is written back into per-session state only when the membership
    changes (a client joins, leaves or skips a tick);
  * uploads happen at submit() time through the same ``upload_frame``
    that ``FrameStream`` uses, so every client's next acquisition is on
    the card before its tick.

On a communicator of N ranks every rank runs the same workload on its
coils of every client (the batched frame's rows share each collective);
after a lost rank, :meth:`NlinvStreamWorkload.remesh` continues every
live stream on the survivor communicator.

:class:`LMDecodeWorkload` is greedy continuous-batching LM decode:
admission = prefill into a KV slot from the explicit :class:`SlotPool`,
one tick = one decode step per active request, close = slot free.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ft.remesh import gather_carry, migrate_carry, pad_rows
from ..nlinv.operators import sobolev_weight
from ..nlinv.recon import Reconstructor, pad_channels
from ..nlinv.stream import upload_frame
from ..task import Executor, TaskGraph
from .scheduler import Rejected, Session, Workload


def stack_carries(carries: list) -> dict:
    """Stack per-session carries (nested dicts of tensors, ``{rho,
    chat}``) on a new leading batch dim, one ``torch.stack`` a leaf."""
    first = carries[0]
    if isinstance(first, dict):
        return {k: stack_carries([c[k] for c in carries]) for k in first}
    return torch.stack(carries)


def unstack_carry(stacked, i: int):
    """Session ``i``'s carry, copied out of the stacked one (a copy, so
    that it outlives the in-place updates of the stack)."""
    if isinstance(stacked, dict):
        return {k: unstack_carry(v, i) for k, v in stacked.items()}
    return stacked[i].clone()


def _rows_finite(a: torch.Tensor) -> torch.Tensor:
    """(B,) bool: every value of each row of ``a`` (B, ...) is finite."""
    return torch.isfinite(a).reshape(a.shape[0], -1).all(dim=1)


class NlinvStreamWorkload(Workload):
    """B NLINV frame solves per tick, one batched program.

    Work item (per ``submit``): a ``(y, mask)`` acquisition with ``y`` of
    shape (J, X, Y) (channel-padded here) and ``mask`` (X, Y).  Result:
    the reconstructed (X, Y) image, finished on the card, or a
    :class:`~repro_torch.serve.Rejected` status when the health check
    finds a non-finite row (the client is quarantined: its carry row is
    re-initialized in place, every other row is untouched).  Geometry
    (grid, coil count, FOV) is fixed per workload, one scanner protocol
    per scheduler; the first session pins it.

    ``retry`` (a ``repro_torch.ft.RestartPolicy``) arms the tick
    executor's transient-task retry; ``operating_points`` is the
    degradation ladder, ``((newton, cg_iters), ...)`` below nominal,
    coarsest last (default: one derived point at about half the CG work).
    Newton/CG depth is part of every batched plan's key, so each point is
    a plan of its own and switching is a cache lookup after the first
    visit.  ``remesh`` moves the live streams onto a survivor
    communicator after a lost rank.
    """

    def __init__(self, rec: Reconstructor, *, damping: float = 0.9,
                 retry=None, operating_points=None):
        self.rec = rec
        self.damping = damping
        self._exec = Executor(retry=retry)
        self._geom = None            # (J_padded, grid), pinned by 1st open
        self._fov_d = self._w_d = None
        # persistent stacked carry: (sids tuple, u_stack, x_ref_stack),
        # plus the Session objects whose carries live in that stack
        self._stack = None
        self._by_sid: dict = {}
        if operating_points is None:
            n0, c0 = rec.newton, rec.cg_iters
            pt = (max(n0 - 1, 1), max(c0 // 2, 2))
            operating_points = () if pt == (n0, c0) else (pt,)
        self._points = ((rec.newton, rec.cg_iters),) \
            + tuple(operating_points)
        self._level = 0
        self.quarantined = 0         # total quarantine events
        self.remeshes = 0            # survivor-group migrations
        self.retired = False         # this rank was lost in a remesh

    def _damp(self, u):
        return {k: self.damping * v for k, v in u.items()}

    # -- degradation ladder (scheduler deadline enforcement) --------------
    @property
    def levels(self) -> int:
        return len(self._points) - 1

    def set_level(self, level: int) -> None:
        """Switch the Newton/CG operating point (0 = nominal).  The carry
        shapes do not depend on the level, so the persistent stack stays
        put; only the plan key changes."""
        if not 0 <= level <= self.levels:
            raise ValueError(f"level {level} outside 0..{self.levels}")
        if level == self._level:
            return
        self._level = level
        self.rec.newton, self.rec.cg_iters = self._points[level]

    def counters(self) -> dict:
        return {"retried_tasks": self._exec.retried,
                "quarantined": self.quarantined,
                "remeshes": self.remeshes}

    def _check_live(self) -> None:
        if self.retired:
            raise RuntimeError(
                "this rank was lost in a remesh: its workload is retired "
                "and serves nothing (the survivor ranks go on)")

    # -- session lifecycle ------------------------------------------------
    def open_session(self, session: Session):
        self._check_live()
        g = int(session.meta["grid"])
        J = pad_channels(np.zeros((int(session.meta["ncoils"]), 1, 1),
                                  np.complex64),
                         self.rec.comm.size).shape[0]
        if self._geom is None:
            self._geom = (J, g)
            self._fov_d = self.rec.put_const(
                np.asarray(session.meta["fov"]))
            self._w_d = self.rec.put_const(
                np.asarray(session.meta.get("weight", sobolev_weight(g))))
        elif self._geom != (J, g):
            raise ValueError(
                f"session geometry (J={J}, grid={g}) does not match the "
                f"workload's {self._geom}: one protocol per scheduler")
        u = self.rec.init_carry(J, g)
        # x_ref starts equal to u but is a tensor of its own
        return {"u": u, "x_ref": {k: v.clone() for k, v in u.items()}}

    def enqueue(self, session: Session, item):
        """Upload at submit time (the serving form of FrameStream's double
        buffer): the frame is on the card before its tick."""
        self._check_live()
        y, mask = item
        y = pad_channels(np.asarray(y), self.rec.comm.size)
        if self._geom is not None:
            # after a remesh the pinned coil dim can exceed the raw
            # padding (J was padded for the old group's size); zero
            # channels are exact NLINV no-ops, so top up
            y = pad_rows(y, self._geom[0])
        return upload_frame(self.rec, y, mask)

    def close_session(self, session: Session) -> None:
        self._spill(keep=lambda sid: sid != session.sid)

    # -- the batched tick -------------------------------------------------
    def _spill(self, keep=lambda sid: True) -> None:
        """Write the stacked carry back into per-session state (dropping
        sessions ``keep`` rejects) and forget the stack."""
        if self._stack is None:
            return
        sids, ub, xb = self._stack
        self._stack = None
        for i, sid in enumerate(sids):
            s = self._by_sid.get(sid)
            # a padded row repeats the last session: its first row is its own
            if s is None or not keep(sid) or sid in sids[:i]:
                continue
            s.state["u"] = unstack_carry(ub, i)
            s.state["x_ref"] = unstack_carry(xb, i)

    def step(self, batch: list, width: int) -> list:
        self._check_live()
        sessions = [s for s, _ in batch]
        B = len(batch)
        # the launch's rows: the sessions, padded to the bucket width by
        # repeating the last one
        sids = tuple(s.sid for s in sessions)
        sids += (sids[-1],) * (width - B)
        if self._stack is not None and self._stack[0] == sids:
            # steady state: the same rows, reused in place.  Only an exact
            # match will do: with the last client skipping, the sessions
            # left are a prefix of the old rows at the same width, but the
            # old last row holds the skipped client's carry, not the pad's
            _, ub, xb = self._stack
        else:
            # membership or width changed: write everyone's carry back to
            # their session BEFORE the new stack is installed
            self._spill()
            # pad the launch to the bucket width by repeating the last
            # session's row (rows are independent; padded rows are
            # computed and discarded)
            rows = sessions + [sessions[-1]] * (width - B)
            ub = stack_carries([s.state["u"] for s in rows])
            xb = stack_carries([s.state["x_ref"] for s in rows])
        pads = [item for _, item in batch]
        pads += [pads[-1]] * (width - B)
        # One tick is one task graph: the stack of the uploaded
        # acquisitions is an explicit copy edge into the batched solve,
        # and the executor waits once, at the end.
        g = TaskGraph()
        g.copy("stack",
               lambda: (torch.stack([yd for yd, _ in pads]),
                        torch.stack([md for _, md in pads])),
               outputs=("yb", "mb"))
        # the stacked carry is replaced every tick, so the solve writes
        # the new one into its tensors (as FrameStream's donated carry)
        g.add("solve", self.rec.fn_batched(width, donate=True),
              inputs=("yb", "mb", "fov", "weight", "u_prev", "xref_prev"),
              outputs=("u", "img"), group=self.rec.comm)
        g.add("damp", self._damp, inputs=("u",), outputs=("xref",),
              group=self.rec.comm)
        vals = self._exec.run(
            g, feeds={"fov": self._fov_d, "weight": self._w_d,
                      "u_prev": ub, "xref_prev": xb},
            outputs=("u", "xref", "img", "yb"))
        ub, xb, imgb = vals["u"], vals["xref"], vals["img"]
        # the health check: every row all-finite over the carry, the image
        # and the acquisition, one (width,) vector to the host.  The INPUT
        # rows matter: a NaN acquisition makes the CG residual NaN, its
        # `rs > thresh` false, and the solve returns du = 0, which would
        # deliver a stale image; the honest outcome is a Rejected frame.
        ok = self._health(ub, imgb, vals["yb"])
        out = []
        for i in range(width):
            if ok[i]:
                if i < B:
                    out.append((imgb[i], False))
                continue
            # quarantine row i: re-initialize its carry row in place (the
            # rows are independent, so every other client's result is
            # bitwise what it would have been without the poison).  Padded
            # rows (i >= B) repeat the last session and are reset too, or
            # the spill would hand it a poisoned carry.
            self._reset_row(ub, xb, i)
            if i < B:
                self.quarantined += 1
                out.append((Rejected("non-finite frame output; client "
                                     "quarantined, carry re-initialized"),
                            False))
        self._stack = (sids, ub, xb)
        self._by_sid = {s.sid: s for s in sessions}
        # NLINV streams are long-lived: never done from inside a tick
        return out

    @staticmethod
    def _health(ub, imgb, yb) -> list[bool]:
        """All-finite per batch row (carry, image, acquisition)."""
        ok = _rows_finite(imgb) & _rows_finite(yb)
        for a in ub.values():
            ok &= _rows_finite(a)
        return ok.tolist()

    def _reset_row(self, ub, xb, i: int) -> None:
        """A fresh carry into batch row ``i`` of the stacked carries."""
        fresh = self.rec.init_carry(*self._geom)
        for st in (ub, xb):
            for k, v in fresh.items():
                st[k][i].copy_(v)

    # -- elastic remesh ---------------------------------------------------
    def remesh(self, comm, sessions=()) -> None:
        """Continue every live stream on a survivor communicator (after
        ``Environment.survivor`` minted one for a lost rank).

        Every rank of the old group calls it, the lost ones with ``comm``
        ``None`` (what ``survivor`` gives them).  The persistent stack is
        spilled and every rank gathers each live session's carries whole
        over the OLD group (``ft.remesh.gather_carry``: the lost ranks'
        coil segments come from them).  A lost rank then retires: its
        sessions' queues are cleared and a later ``step`` raises.  On a
        survivor rank a new :class:`Reconstructor` is built on ``comm``
        with the old options (plan keys carry the group token, so the
        survivor's plans are built fresh), the pinned constants and every
        carry in ``sessions`` are re-placed through ``ft.migrate_carry``
        (coil rows zero-padded to the new group size, which is exact for
        every NLINV sum), and later ticks run on the survivors.  Staged
        uploads lived on the old group: every session's queue is cleared
        and the clients resubmit (a dropped frame beats a dead stream).
        """
        self._check_live()
        self._spill()
        old = self.rec
        live = [s for s in sessions
                if not s.done and isinstance(s.state, dict)]
        whole = [{part: gather_carry(old.comm, s.state[part])
                  for part in ("u", "x_ref")} for s in live]
        self.remeshes += 1
        for s in sessions:
            s.pending.clear()
        if comm is None:
            self.retired = True
            return
        self.rec = Reconstructor(comm, device=old.device, newton=old.newton,
                                 cg_iters=old.cg_iters,
                                 channel_sum=old.channel_sum,
                                 fused=old.fused, impl=old.impl,
                                 overlap=old.overlap,
                                 hierarchical=old.hierarchical)
        self.rec.plan_cache = old.plan_cache
        if self._geom is None:
            return
        J, g = self._geom
        size = self.rec.comm.size
        Jp = -(-J // size) * size
        self._geom = (Jp, g)
        self._fov_d = self.rec.put_const(self._fov_d.cpu().numpy())
        self._w_d = self.rec.put_const(self._w_d.cpu().numpy())
        for s, carry in zip(live, whole):
            for part in ("u", "x_ref"):
                s.state[part] = migrate_carry(self.rec, carry[part],
                                              pad_to=Jp)


class SlotPool:
    """Explicit KV-slot bookkeeping for continuous batching: ``assign``
    takes the lowest free slot, ``free`` returns it.  Every transition
    is checked: a double free or an over-assign is a bug in the caller,
    never silent state corruption."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError("SlotPool needs at least one slot")
        self.n = n
        self._free = list(range(n))
        self._used: set[int] = set()

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> tuple:
        return tuple(sorted(self._used))

    def assign(self) -> int:
        if not self._free:
            raise RuntimeError(f"SlotPool exhausted ({self.n} slots in use)")
        slot = self._free.pop(0)
        self._used.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._used:
            raise RuntimeError(f"SlotPool.free({slot}): slot not assigned")
        self._used.remove(slot)
        self._free.append(slot)
        self._free.sort()


class LMDecodeWorkload(Workload):
    """Greedy LM decode as a Workload: one KV slot per admitted request,
    one decode step per work item.  Work items carry no payload (the
    token fed back is the previous output); results are token ids.
    ``device=None`` is the card."""

    def __init__(self, cfg, params, *, batch: int = 4, max_len: int = 512,
                 device=None):
        from .engine import make_serve_steps
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        pf, dec, mk = make_serve_steps(cfg, max_len=max_len, batch=1,
                                       device=self.device)
        self._prefill, self._decode, self._mk_cache = pf, dec, mk
        self.slots = SlotPool(batch)

    def open_session(self, session: Session):
        from ..models import frontends
        prompt = list(session.meta["prompt"])
        slot = self.slots.assign()
        enc = frontends.synthetic_frontend(self.cfg, 1, device=self.device)
        cache = self._mk_cache()
        toks = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        logits, cache = self._prefill(self.params, toks, cache, enc=enc)
        # the prefill emits the first output token at admission
        session.results.append(int(torch.argmax(logits[0])))
        return {"slot": slot, "cache": cache, "pos": len(prompt)}

    def step(self, batch: list, width: int) -> list:
        out = []
        for session, _ in batch:
            st = session.state
            tok = torch.tensor([[session.results[-1]]], dtype=torch.int64,
                               device=self.device)
            logits, st["cache"] = self._decode(self.params, tok,
                                               st["cache"], st["pos"])
            st["pos"] += 1
            nxt = int(torch.argmax(logits[0]))
            produced = len(session.results) + 1   # incl. this token
            done = (produced >= int(session.meta["max_new"])
                    or st["pos"] >= self.max_len - 1)
            out.append((nxt, done))
        return out

    def close_session(self, session: Session) -> None:
        self.slots.free(session.state["slot"])
