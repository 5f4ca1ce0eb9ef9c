"""Start the ranks of a group on one host, each in a process of its own.

``run_ranks(fn, n)`` spawns ``n`` processes (the ``spawn`` method: the
caller may hold threads that ``fork`` would copy mid-flight), gives each
an :class:`~repro_torch.core.env.Environment` over one ``FileStore`` (no
TCP port, so runs side by side do not collide), calls ``fn(env, *args)``
there and returns the ranks' results in rank order.  Nothing waits
without a bound: the process group's collectives raise after
``timeout`` seconds, and the parent kills every rank still alive at its
own deadline, so a rank that hangs or dies fails the call instead of
stalling it.

``fn`` and ``args`` go to the ranks by pickling: ``fn`` must be a
module-level function of an importable module, and its result must
pickle without tensors (return numpy arrays: ``torch.multiprocessing``
would send a tensor as a file descriptor that ends with its rank).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback


def _rank_main(fn, rank, world, backend, device, shared_card, store_path,
               timeout, args, results):
    import torch
    import torch.distributed as dist

    from .env import Environment
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(store_path, world)
        env = Environment(rank, world, store=store, backend=backend,
                          device=device, shared_card=shared_card,
                          timeout=timeout)
        try:
            out = fn(env, *args)
        finally:
            env.close()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, nranks: int, *, backend: str = "gloo", device=None,
              shared_card: bool = False, args: tuple = (),
              timeout: float = 120.0, store_dir=None) -> list:
    """``[fn(env_0, *args), ..., fn(env_{n-1}, *args)]``, each in its own
    rank process.  ``backend``, ``device`` and ``shared_card`` go to
    every rank's ``Environment``; ``store_dir`` holds the store (a fresh
    temporary directory by default).  Raises ``RuntimeError`` with the
    ranks' tracebacks when one fails, ``TimeoutError`` when they are not
    done within ``timeout`` seconds; every process started here has
    ended when it returns."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks-", dir=store_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nranks, backend, device, shared_card,
                               os.path.join(tmp, "store"), timeout, args,
                               results))
             for r in range(nranks)]
    got: dict[int, tuple[bool, object]] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        # drain the queue before joining: a rank blocks on a full pipe
        while len(got) < nranks:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                # a rank that died without a word (a crash) ends the wait
                if any(p.exitcode not in (None, 0) and r not in got
                       for r, p in enumerate(procs)):
                    break
                continue
            got[rank] = (ok, value)
            if not ok:
                break
        if len(got) == nranks and all(ok for ok, _ in got.values()):
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    failed = {r: v for r, (ok, v) in got.items() if not ok}
    if failed:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
    missing = sorted(set(range(nranks)) - set(got))
    if missing:
        codes = {r: procs[r].exitcode for r in missing}
        raise TimeoutError(f"ranks {missing} gave no result within "
                           f"{timeout} s (exit codes {codes})")
    return [got[r][1] for r in range(nranks)]
