"""The port's serving launcher, ``python -m repro_torch.launch.serve``, on
a SMOKE arch with ``--device cpu``: it serves its requests and prints the
JAX launcher's lines, its tokens are ``Engine``'s on the same weights and
prompts, and without a card it runs only when the CPU is asked for."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch.serve import main
from repro_torch.models import transformer
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "qwen3-0.6b", "--smoke", "--requests", "3",
        "--max-new", "5", "--batch", "2", "--max-len", "64"]
# the JAX launcher's lines (``repro/launch/serve.py:45-49``)
SERVED = re.compile(r"^served (\d+) requests, (\d+) tokens in [\d.]+s "
                    r"\([\d.]+ tok/s\)$")
REQUEST = re.compile(r"^  req \d+: prompt\[:4\]=\[[\d, ]+\] "
                     r"out\[:8\]=\[[\d, ]+\]$")


def test_cli_serves_its_requests_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *ARGS,
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    m = SERVED.match(lines[0])
    assert m and (int(m[1]), int(m[2])) == (3, 15), lines[0]
    assert len(lines) == 4 and all(REQUEST.match(x) for x in lines[1:])


def test_tokens_are_the_engines():
    """The launcher's requests through an ``Engine`` of the same float32
    weights (generator seeded ``--seed``) and prompts
    (``default_rng(seed)``) give the same tokens."""
    done = main(ARGS + ["--seed", "3"], device="cpu")
    cfg = dataclasses.replace(get_smoke("qwen3-0.6b"),
                              compute_dtype="float32")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     device="cpu")
    eng = Engine(cfg, params, batch=2, max_len=64, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(3):
        plen = int(rng.integers(4, 17))
        eng.submit(rng.integers(0, cfg.vocab, plen).tolist(), max_new=5)
    want = eng.run()
    assert [r.prompt for r in done] == [r.prompt for r in want]
    assert [r.out for r in done] == [r.out for r in want]
    assert all(len(r.out) == 5 for r in done)


def test_needs_the_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(ARGS)
    assert len(main(ARGS + ["--device", "cpu"])) == 3
