"""The LM workload behind ``StreamScheduler``, as the LM half of
``repro/serve/workloads.py``.

:class:`LMDecodeWorkload` is greedy continuous-batching LM decode:
admission = prefill into a KV slot from the explicit :class:`SlotPool`,
one tick = one decode step per active request, close = slot free.  The
NLINV stream workload comes with the port's batched frame (ROADMAP
Queue 1 item 7).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .scheduler import Session, Workload


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
        enc = frontends.synthetic_frontend(self.cfg, 1)
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
