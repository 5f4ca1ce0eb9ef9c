#!/usr/bin/env python3
"""Flash attention, the mLSTM or the RG-LRU scan of one checkout on the
card, to compare two commits.

    python3 scripts/flash_compare.py DIR [--serve] [--kernel mlstm|rg_lru]

Imports the package of the checkout at ``DIR`` (built into that checkout's
``build/``), and prints the device ms (``torch.profiler``, three readings)
and the events ms of its ``flash_attention`` at the four rows of PERF.md's
kernel table: recurrentgemma-2b's windowed MQA prefill (row 12), the two
MLA prefills (12b) and llama3.2-3b's GQA prefill (12c), all bf16, causal.
With ``--serve`` it then serves llama3.2-3b, deepseek-v2-lite-16b and
minicpm3-4b through that checkout's ``chip_smoke.phase_lm``, as phase 11
does (their prefill ms lines).  With ``--kernel mlstm`` it times the
checkout's ``mlstm`` instead at row 13's shape, xlstm-350m's prefill (q,
k, v (1, 4, 3072, 512) in bf16, chunk 128, the zero state; the spec's
sample), with the device ms of each CUDA kernel of the call.  With
``--kernel rg_lru`` it times the checkout's ``rg_lru_scan`` at row 14's
shape, recurrentgemma-2b's rglru layers at the 3072-token prompt (log_a
and b (1, 3072, 2560) and h0 (1, 2560) in float32; the spec's sample at
seed 0), with the device ms of each CUDA kernel of the call, and prints a
sha256 of the outputs (hs, then h_last), so that two checkouts' bits can
be compared, and the device ms of ``torch.add(log_a, b)``, which reads
and writes the scan's bytes (a yardstick of the memory's rate, not of
the scan).  To compare a parent commit with a change, unpack both
(``git archive``) and run the script on each in turns: parent, change,
change, parent.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

# (B, Hq, Hkv, S, D, Dv, keywords)
SHAPES = {
    "12 recurrentgemma-2b": (1, 10, 1, 3072, 256, 256,
                             {"causal": True, "window": 2048}),
    "12b deepseek-v2-lite-16b": (1, 16, 16, 2048, 192, 128,
                                 {"causal": True}),
    "12b minicpm3-4b": (1, 40, 40, 2048, 96, 64, {"causal": True}),
    "12c llama3.2-3b": (1, 24, 8, 2048, 128, 128, {"causal": True}),
}
SERVED = ("llama3.2-3b", "deepseek-v2-lite-16b", "minicpm3-4b")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkout", type=Path)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--kernel",
                    choices=("flash_attention", "mlstm", "rg_lru"),
                    default="flash_attention")
    args = ap.parse_args()
    root = args.checkout.resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    if not torch.cuda.is_available():
        print("flash_compare: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    _build.build()
    _build.load()
    print(f"[{root.name}] build {time.perf_counter() - t0:.1f} s",
          flush=True)
    device = torch.device("cuda")
    card = cs.card_line()
    gen = torch.Generator(device=device).manual_seed(0)
    if args.kernel == "mlstm":
        return _mlstm(root, device, card, gen)
    if args.kernel == "rg_lru":
        return _rg_lru(root, device, card, gen)
    for name, (B, Hq, Hkv, S, D, Dv, kw) in SHAPES.items():
        q, k, v = (torch.randn(s, device=device, generator=gen).to(
            torch.bfloat16) for s in ((B, Hq, S, D), (B, Hkv, S, D),
                                      (B, Hkv, S, Dv)))

        def call(q, k, v):
            return flash_attention(q, k, v, **kw)
        dev = [cs.device_ms(call, (q, k, v))[0] for _ in range(3)]
        ev = cs.time_ms(call, (q, k, v))
        print(f"[{root.name}] {name}: device ms "
              f"{[round(x, 5) for x in dev]}, events {ev:.5f} [{card}]",
              flush=True)
        del q, k, v
    if args.serve:
        for arch in SERVED:
            cs.phase_lm(device, card, arch,
                        cs.CONFIG_PROMPTS_OF.get(arch, cs.CONFIG_PROMPTS),
                        cs.CONFIG_MAX_NEW,
                        f32_depth=cs.CONFIG_F32_DEPTH.get(arch, 2))
    return 0


def _mlstm(root, device, card, gen) -> int:
    """Row 13: the checkout's mLSTM at its spec's sample."""
    import chip_smoke as cs
    from repro_torch.kernels import registry
    spec = registry.get("mlstm")
    sample = spec.sample(device, gen)
    readings = [cs.device_ms(spec.kernel, sample) for _ in range(3)]
    ev = cs.time_ms(spec.kernel, sample)
    split = {k: round(v, 5) for k, v in readings[-1][1].items()}
    print(f"[{root.name}] 13 xlstm-350m mlstm: device ms "
          f"{[round(r[0], 5) for r in readings]}, events {ev:.5f}, by "
          f"kernel {split} [{card}]", flush=True)
    return 0


def _rg_lru(root, device, card, gen) -> int:
    """Row 14: the checkout's RG-LRU scan at its spec's sample, and a hash
    of its outputs' bits."""
    import hashlib

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import registry
    from repro_torch.kernels.rg_lru import rg_lru_scan
    sample = registry.get("rg_lru").sample(device, gen)
    readings = [cs.device_ms(rg_lru_scan, sample) for _ in range(3)]
    ev = cs.time_ms(rg_lru_scan, sample)
    split = {k: round(v, 5) for k, v in readings[-1][1].items()}
    digest = hashlib.sha256()
    for t in rg_lru_scan(*sample):
        digest.update(t.cpu().numpy().tobytes())
    # the same bytes through one elementwise call: log_a and b read once,
    # one output written (not the scan: a yardstick of the memory's rate)
    same = [cs.device_ms(torch.add, sample[:2])[0] for _ in range(3)]
    print(f"[{root.name}] 14 recurrentgemma-2b rg_lru "
          f"{tuple(sample[1].shape)}: device ms "
          f"{[round(r[0], 5) for r in readings]}, events {ev:.5f}, by "
          f"kernel {split}, outputs sha256 {digest.hexdigest()[:16]}; "
          f"torch.add of log_a and b, the same bytes: device ms "
          f"{[round(x, 5) for x in same]} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
