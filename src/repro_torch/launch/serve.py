"""Serving driver, the port of ``repro/launch/serve.py``: batched greedy
decoding with the slot engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu

The JAX launcher's flags and printed lines, float32 compute as there, on
the card unless ``--device cpu`` (or a caller's ``main(...,
device="cpu")``) asks otherwise.  Random weights from a generator seeded
``--seed``, the prompts' lengths and tokens from numpy's
``default_rng(seed)`` as there.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke
from ..device import resolve_device
from ..models import transformer
from ..serve import Engine


def main(argv=None, *, device=None):
    """Parse ``argv`` and serve; ``device`` overrides ``--device``.
    Returns the finished requests in rid order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path; the card by default")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device if device is None else device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = transformer.init_params(cfg, gen, device=dev)
    eng = Engine(cfg, params, batch=args.batch, max_len=args.max_len,
                 device=dev)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for r in range(args.requests):
        plen = int(rng.integers(4, 17))
        eng.submit(rng.integers(0, cfg.vocab, plen).tolist(),
                   max_new=args.max_new)
    done = eng.run()
    dt = time.time() - t0
    ntok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {ntok} tokens "
          f"in {dt:.2f}s ({ntok / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} out[:8]={r.out[:8]}")
    return done


if __name__ == "__main__":
    main()
