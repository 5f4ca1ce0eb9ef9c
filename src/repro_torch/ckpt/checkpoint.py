"""Checkpointing: atomic, async, keep-N, elastic re-placement on restore,
as ``repro/ckpt/checkpoint.py``.

Layout: ``<dir>/step_<n>/ {meta.json, arrays.npz}`` committed through a
tmp-dir rename (a partly written checkpoint is never visible).  Leaves
are stored by tree path, so a restore works across code changes that
keep the names, and :func:`restore_sharded` places every leaf on the
current group, whatever group wrote it (elastic scaling: any rank count
to any other).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or scalars; an ``nn.Module`` stands for the dict of its named
parameters (a train state's ``params``), its dotted names split into
path parts.  Bytes are copied to the host before :func:`save` returns,
so the caller may update the tree in place while a write runs on its
thread.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn


def _items(node):
    """(key, child) pairs of an inner node, None for a leaf."""
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _leaves(tree, prefix=()):
    """(path, leaf) of every leaf, a path the '/'-joined keys."""
    items = _items(tree)
    if items is None:
        yield "/".join(prefix), tree
        return
    for k, child in items:
        yield from _leaves(child, prefix + tuple(str(k).split(".")))


def _map(tree, fn, prefix=()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``;
    a module becomes the dict of its parameters by name."""
    items = _items(tree)
    if items is None:
        return fn("/".join(prefix), tree)
    out = {k: _map(child, fn, prefix + tuple(str(k).split(".")))
           for k, child in items}
    if isinstance(tree, (list, tuple)):
        return type(tree)(out[i] for i in range(len(items)))
    return out


def _host(leaf) -> np.ndarray:
    """A copy of the leaf on the host (never a view of a tensor that the
    caller may go on updating).  numpy has no bfloat16: such a leaf is
    stored as float32, which holds it exactly, and a restore into a
    bfloat16 leaf gives back its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(ckpt_dir, step: int, tree, *, keep: int = 3, blocking=True):
    """Atomic checkpoint of a tree of tensors.  With ``blocking=False`` the
    files are written on a thread, which is returned (the host copy is
    made before); its ``join`` raises what the write raised."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    host = {path: _host(leaf) for path, leaf in _leaves(tree)}

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        np.savez(tmp / "arrays.npz", **host)
        meta = {"step": step, "time": time.time(),
                "keys": sorted(host.keys())}
        (tmp / "meta.json").write_text(json.dumps(meta))
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                       # atomic commit
        _gc(ckpt_dir, keep)

    if blocking:
        _write()
        return None
    t = _Writer(_write)
    t.start()
    return t


class _Writer(threading.Thread):
    """A checkpoint's write on a thread of its own; ``join`` raises what
    the write raised (a full disk), which a plain thread would only
    print."""

    def __init__(self, write):
        super().__init__(daemon=True)
        self._write = write
        self.error = None

    def run(self):
        try:
            self._write()
        except BaseException as e:  # noqa: BLE001 -- handed to join()
            self.error = e

    def join(self, timeout=None):
        super().join(timeout)
        if self.error is not None:
            raise self.error


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
    for tmp in ckpt_dir.glob(".tmp_step_*"):   # crashed writers
        if time.time() - tmp.stat().st_mtime > 3600:
            shutil.rmtree(tmp, ignore_errors=True)


def list_steps(ckpt_dir) -> list[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "meta.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir):
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, tree_like, step: int | None = None):
    """Restore as host numpy arrays shaped like ``tree_like`` (the latest
    step when ``step`` is None).  Returns (tree, step)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with np.load(ckpt_dir / f"step_{step}" / "arrays.npz") as data:
        return _map(tree_like, lambda path, _: data[path]), step


def _place(x: np.ndarray, like, placement):
    """One leaf in ``like``'s dtype on its placement: a device (the leaf
    whole, as a tensor), or a ``(comm, policy, dim)`` tuple: this rank's
    container of it."""
    if isinstance(like, np.ndarray):
        x = x.astype(like.dtype)
    dtype = like.dtype if isinstance(like, torch.Tensor) else None
    if isinstance(placement, tuple):
        comm, policy, dim = placement
        return comm.container(x, policy=policy, dim=dim, dtype=dtype)
    return torch.from_numpy(np.array(x, order="C")).to(placement,
                                                       dtype=dtype)


def _place_tree(host, like, placement):
    items = _items(like)
    if items is None:
        return _place(host, like, placement)
    likes = dict(items)
    if isinstance(placement, (dict, list)):      # a tree of placements
        def sub(k):
            return placement[k]
    else:
        def sub(k):
            return placement
    if isinstance(host, dict):
        return {k: _place_tree(h, likes[k], sub(k)) for k, h in host.items()}
    return type(host)(_place_tree(h, likes[i], sub(i))
                      for i, h in enumerate(host))


def restore_sharded(ckpt_dir, tree_like, placements, step=None):
    """Elastic restore: lay every leaf out onto the current group,
    whatever group wrote it (checkpoints are group-agnostic).  Returns
    (tree, step).

    ``placements`` is one placement for every leaf, or a tree of dicts
    and lists of them shaped like ``tree_like`` down to any depth (a
    placement there holds for the whole subtree; a module's entry is one
    placement, or a dict by parameter name).  A placement is a device
    (the leaf whole, as a tensor, on every rank that restores) or a
    ``(comm, policy, dim)`` tuple: this rank's container of the leaf on
    ``comm`` under the ``Policy`` and ``dim`` that
    ``Communicator.container`` takes, the port's counterpart of a
    ``NamedSharding``."""
    host_tree, step = restore(ckpt_dir, tree_like, step)
    return _place_tree(host_tree, tree_like, placements), step
