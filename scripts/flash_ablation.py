#!/usr/bin/env python3
"""Ablations of flash attention's bf16 kernel on the card: what bounds it.

    python3 scripts/flash_ablation.py [--variants base,no_softmax,...]

Builds copies of ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
parts of the consumers' work taken out, each into its own library under
``build/flash_ablation/`` (``nvcc`` for ``sm_90a``, all at once), and times
each copy's ``flash_attention_bf16`` entry on the device (``torch.profiler``,
as ``chip_smoke.py``'s kernels phase) at the four rows of PERF.md's kernel
table: recurrentgemma-2b's windowed MQA prefill (row 12), the two MLA
prefills (12b) and llama3.2-3b's GQA prefill (12c).  Each variant runs in a
process of its own, so that one that faults cannot hide the others.

Variants (a variant's outputs are wrong by design; only its time counts):

- ``base``: the kernel as it is;
- ``no_softmax``: the scale, softcap, mask and online softmax left out (P
  is S rounded): the products and the loads;
- ``no_products``: no wgmma issued: the loads and the softmax;
- ``loads_only``: neither: the TMA ring, the barriers and the epilogue;
- ``no_mask``: the softcap and the per-element mask left out.

Prints one line per variant and shape, and the JSON of all of them last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_ablation"

_SOFTMAX = {"softmax(t_begin * kBK, alpha);": "alpha[0] = alpha[1] = 1.f;",
            "softmax((t_begin + i) * kBK, alpha);":
                "alpha[0] = alpha[1] = 1.f;"}
_PRODUCTS = {"Wgmma<kBK>::ss(": "if (false) Wgmma<kBK>::ss(",
             "Wgmma<kDv>::rs_t(": "if (false) Wgmma<kDv>::rs_t("}
VARIANTS = {
    "base": {},
    "no_softmax": _SOFTMAX,
    "no_products": _PRODUCTS,
    "loads_only": {**_SOFTMAX, **_PRODUCTS},
    "no_mask": {"      if (softcap > 0.f) {": "      if (false) {",
                "      if (!interior) {": "      if (false) {"},
}
# (B, Hq, Hkv, S, D, Dv, window); causal, T = S
SHAPES = {"12 recurrentgemma-2b": (1, 10, 1, 3072, 256, 256, 2048),
          "12b deepseek-v2-lite-16b": (1, 16, 16, 2048, 192, 128, None),
          "12b minicpm3-4b": (1, 40, 40, 2048, 96, 64, None),
          "12c llama3.2-3b": (1, 24, 8, 2048, 128, 128, None)}


def build(names) -> None:
    """One library per variant, compiled concurrently; raises with the
    compiler's log if one fails or a substitution finds nothing."""
    from repro_torch.kernels import _build
    src = (CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in VARIANTS[name].items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (d / "flash_attention.cu").write_text(text)
        (d / "hopper_bf16.cuh").write_text(
            (CSRC / "hopper_bf16.cuh").read_text())
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-shared",
             str(d / "flash_attention.cu"), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")


def run(name) -> dict:
    """Device ms of the variant's entry at each shape."""
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import ops
    fn = ctypes.CDLL(str(OUT / name / "lib.so")).flash_attention_bf16
    fn.argtypes = list(ops.FLASH_ATTENTION.argtypes)
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for shape, (B, Hq, Hkv, S, D, Dv, window) in SHAPES.items():
        q, k, v = (torch.randn(s, device=dev, generator=gen).to(
            torch.bfloat16) for s in ((B, Hq, S, D), (B, Hkv, S, D),
                                      (B, Hkv, S, Dv)))
        o = torch.empty((B, Hq, S, Dv), device=dev, dtype=torch.bfloat16)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())

        def call():
            err = fn(*ptrs, o.data_ptr(), B, Hq, Hkv, S, S, D, Dv,
                     1.0 / math.sqrt(D), 0.0, 1,
                     ops._NO_WINDOW if window is None else window, S, 0,
                     ops.LOADERS[ops.loader(D, Dv, *ptrs)], stream)
            if err:
                raise RuntimeError(f"{name} at {shape}: error {err}")
        out[shape] = chip_smoke.device_ms(call, ())[0]
        del q, k, v, o
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        print(json.dumps(run(args.run)), flush=True)
        return 0
    import chip_smoke
    names = args.variants.split(",")
    build(names)
    card = chip_smoke.card_line()
    result = {}
    for name in names:
        p = subprocess.run([sys.executable, __file__, "--run", name],
                           capture_output=True, text=True, timeout=300)
        if p.returncode:
            print(f"{name}: exit {p.returncode}\n{p.stderr[-2000:]}",
                  flush=True)
            result[name] = None
            continue
        result[name] = json.loads(p.stdout.strip().splitlines()[-1])
        for shape, ms in result[name].items():
            print(f"{name} {shape}: device {ms:.5f} ms [{card}]", flush=True)
    print(json.dumps({"card": card, "device_ms": result}), flush=True)
    return 0 if all(result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
