"""Deterministic synthetic token pipeline (host-sharded, resumable).

The port's own copy of ``repro/data/pipeline.py``, pure numpy: the same
``(seed, step, host_id)`` gives the JAX package's tokens bit for bit.

Sequences follow a fixed random Markov chain over the vocab so that a
language model has real structure to learn (a falling train loss is a
meaningful signal).  Every batch is a pure function of ``(seed, step,
host_id)``: the data order is reproducible across restarts and across
host counts, which checkpoint-resume correctness rests on.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int                      # per-host batch
    seq: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    branching: int = 8              # markov out-degree
    step: int = 0                   # resumable cursor

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._next = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.branching))

    def batch_at(self, step: int):
        """(tokens, labels) int32 (batch, seq) for a global step (this
        host's slice)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        starts = rng.integers(0, self.vocab, size=self.batch)
        choices = rng.integers(0, self.branching,
                               size=(self.batch, self.seq))
        toks = np.empty((self.batch, self.seq + 1), np.int32)
        toks[:, 0] = starts
        for t in range(self.seq):
            toks[:, t + 1] = self._next[toks[:, t], choices[:, t]]
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self):
        return self

    def __next__(self):
        out = self.batch_at(self.step)
        self.step += 1
        return out

    def state(self):
        return {"step": self.step}

    def restore(self, state):
        self.step = int(state["step"])
