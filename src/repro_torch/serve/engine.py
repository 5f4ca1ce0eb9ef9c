"""LM serving entry point, as ``repro/serve/engine.py``: the prefill and
decode step functions plus the ``Engine`` front door.  ``Engine`` is a
thin request-tracking wrapper over the shared
:class:`~repro_torch.serve.scheduler.StreamScheduler` driving
:class:`~repro_torch.serve.workloads.LMDecodeWorkload`; there is no
bespoke decode loop here.

Everything runs on the card unless ``device="cpu"`` is asked for, and
raises without a card.  The steps run under ``torch.no_grad``.  With a
``mesh`` (a ``Communicator`` of ``("data", "model")`` axes) they run this
rank's part of the sharded step: the weights and the cache split by the
JAX package's specs (``models/sharding.py``), every arch, the recurrent
archs' states included.
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from ..device import resolve_device
from ..models import transformer


def make_serve_steps(cfg, mesh=None, *, max_len=2048, batch=8, tp="model",
                     batch_axes=("data",), device=None, act_sharding=None):
    """Returns (prefill_fn, decode_fn, init_cache_fn) on ``device`` (the
    card when None).  The steps write the cache they are given in place
    and return it.  The prefill takes the frontend embeddings ``enc`` of
    a cross-attention arch; decode reads them from the cross cache.

    ``mesh``: a ``Communicator`` (or ``DeviceGroup``) with named axes,
    every rank of which calls the steps with the same global ``tokens``
    (``batch`` rows) and ``enc``.  The parameters are this rank's shards
    (``models.sharding.shard_params``, ``init_shards`` or
    ``convert.params_from_numpy(mesh=)``, with ``fsdp=batch_axes``),
    ``init_cache`` allocates this rank's slice of the cache
    (``cache_pspecs`` with ``kv_shard="seq"``), the batch splits over
    ``batch_axes``, and the logits come back whole, ``(batch, vocab)``, on
    every rank.  The device is the mesh's.  ``act_sharding`` ``(batch_axes,
    "model", None)``: the sharded prefill's sequence parallelism
    (``transformer.apply``); decode takes none."""
    if mesh is not None:
        return _sharded_steps(cfg, mesh, max_len=max_len, batch=batch,
                              tp=tp, batch_axes=batch_axes, device=device,
                              act_sharding=act_sharding)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill(params, tokens, cache, enc=None, pos=0):
        logits, cache, _ = transformer.apply(
            cfg, params, tokens, enc=enc, mode="prefill", pos=pos,
            cache=cache, logits_window=1)
        return logits[:, -1], cache

    @torch.no_grad()
    def decode(params, tokens, cache, pos):
        logits, cache, _ = transformer.apply(
            cfg, params, tokens, enc=None, mode="decode", pos=pos,
            cache=cache)
        return logits[:, -1], cache

    def init_cache():
        return transformer.init_cache(cfg, batch, max_len, cfg.cdtype,
                                      device=dev)

    return prefill, decode, init_cache


def _sharded_steps(cfg, mesh, *, max_len, batch, tp, batch_axes, device,
                   act_sharding):
    from ..models import sharding
    sh = sharding.Sharding(mesh, tp=tp, batch_axes=batch_axes, batch=batch)
    if device is not None and torch.device(device) != sh.device:
        raise ValueError(f"the mesh's ranks run on {sh.device}, not "
                         f"{device}")
    layout = sharding.cache_layout(cfg, sh, batch, max_len, cfg.cdtype)

    def run(params, tokens, cache, enc, mode, pos):
        sh.check(params)
        if tokens.shape[0] != batch:
            raise ValueError(f"tokens of {tokens.shape[0]} rows for a cache "
                             f"of {batch}")
        tok = sh.take_rows(tokens).to(sh.device)
        if enc is not None:
            enc = sh.take_rows(enc).to(sh.device)
        logits, cache, _ = transformer.apply(
            cfg, params, tok, enc=enc, mode=mode, pos=pos, cache=cache,
            logits_window=1 if mode == "prefill" else None, shard=sh,
            act_sharding=act_sharding if mode == "prefill" else None)
        return sh.gather_rows(logits[:, -1]), cache

    @torch.no_grad()
    def prefill(params, tokens, cache, enc=None, pos=0):
        return run(params, tokens, cache, enc, "prefill", pos)

    @torch.no_grad()
    def decode(params, tokens, cache, pos):
        return run(params, tokens, cache, None, "decode", pos)

    def init_cache():
        return sharding.init_cache(layout, sh.device)

    return prefill, decode, init_cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Greedy continuous-batching LM server over ``batch`` KV slots.

    Front door only: admission, slot assignment, batching, ticking and
    reclamation all live in the shared ``StreamScheduler`` +
    ``LMDecodeWorkload`` (prefill at admission, one decode per tick,
    slot freed through the explicit ``SlotPool`` on completion).
    Request ids come from a monotonic counter — submitting after a
    drain can never reuse a live rid.  Deterministic: greedy argmax.
    ``device=None`` is the card.
    """

    def __init__(self, cfg, params, *, batch=4, max_len=512, device=None):
        from .scheduler import ServeConfig, StreamScheduler
        from .workloads import LMDecodeWorkload
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.workload = LMDecodeWorkload(cfg, params, batch=batch,
                                         max_len=max_len, device=device)
        # decode items are enqueued all at submit time, so the per-
        # session depth bound must admit the longest request; admission
        # (slot) pressure is the real LM bound.
        self.scheduler = StreamScheduler(self.workload, ServeConfig(
            max_concurrency=batch, max_queue=2 ** 30,
            queue_depth=max(max_len, 1), buckets=(batch,)))
        self._rids = itertools.count()
        self._requests: dict[int, tuple[Request, object]] = {}

    def submit(self, prompt, max_new=32) -> int:
        rid = next(self._rids)
        req = Request(rid, list(prompt), max_new)
        sess = self.scheduler.open(client=f"req{rid}", prompt=req.prompt,
                                   max_new=max_new)
        # prefill (at admission) emits token 1; each decode tick emits one
        for _ in range(max(max_new - 1, 0)):
            self.scheduler.submit(sess, None)
        self._requests[rid] = (req, sess)
        return rid

    def _collect(self) -> list[Request]:
        finished = []
        for rid, (req, sess) in list(self._requests.items()):
            if (sess.admitted and not sess.done and not sess.pending
                    and len(sess.results) >= req.max_new):
                # prefill-only request (max_new <= 1): complete at
                # admission, no decode tick ever fires for it
                self.scheduler.close(sess)
            if sess.done and not req.done:
                req.out = list(sess.results)
                req.done = True
                finished.append(req)
        return finished

    def step(self) -> list[Request]:
        """One scheduler tick; returns the requests it completed."""
        self.scheduler.tick()
        return self._collect()

    def run(self) -> list[Request]:
        """Drain every submitted request; returns them in rid order."""
        while True:
            n = self.scheduler.drain()
            # a drain that moved nothing and completed nothing cannot
            # make progress on the next pass either
            if not self._collect() and n == 0:
                break
            if all(req.done for req, _ in self._requests.values()):
                break
        done = [req for rid, (req, _) in sorted(self._requests.items())
                if req.done]
        for req in done:                 # returned once; engine stays usable
            self._requests.pop(req.rid)
        return done
