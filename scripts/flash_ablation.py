#!/usr/bin/env python3
"""Ablations of a bf16 wgmma kernel on the card: what bounds it.

    python3 scripts/flash_ablation.py [--kernel mlstm] [--variants base,...]

Builds copies of the kernel's source (``flash_attention.cu``, or
``mlstm.cu`` with ``--kernel mlstm``, from ``src/repro_torch/kernels/
csrc/``) with parts of its work taken out, each into its own library under
``build/flash_ablation/`` (``nvcc`` for ``sm_90a``, all at once), and
times each copy's bf16 entry on the device (``torch.profiler``, as
``chip_smoke.py``'s kernels phase).  Flash attention is timed at the four
rows of PERF.md's kernel table: recurrentgemma-2b's windowed MQA prefill
(row 12), the two MLA prefills (12b) and llama3.2-3b's GQA prefill (12c);
the mLSTM at row 13, xlstm-350m's prefill (the spec's sample), through
the port's own wrapper with the copy's entry in place of the built one,
each of its two CUDA kernels' device ms beside the call's.
Each variant runs in a process of its own, so that one that faults cannot
hide the others.

Variants (a variant's outputs are wrong by design; only its time counts).
Flash attention:

- ``base``: the kernel as it is;
- ``no_softmax``: the scale, softcap, mask and online softmax left out (P
  is S rounded): the products and the loads;
- ``no_products``: no wgmma issued: the loads and the softmax;
- ``loads_only``: neither: the TMA ring, the barriers and the epilogue;
- ``no_mask``: the softcap and the per-element mask left out.

The mLSTM:

- ``base``: the two kernels as they are;
- ``walk_only``: the state walk alone (the output pass not launched);
- ``out_only``: the output pass alone, over a scratch the walk did not
  write;
- ``no_store``: the walk's TMA stores of the entering states left out;
- ``no_qc``: the output pass's q C products left out;
- ``loads_only``: no wgmma in either kernel: the loads, the stores, the
  gates and the statistics.

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
_NO_PRODUCTS = {w: f"if (false) {w}" for w in
                ("Wgmma<128>::ss(", "Wgmma<128>::ss_t(", "Wgmma<128>::tt(",
                 "Wgmma<64>::rs_t_at<")}
MLSTM_VARIANTS = {
    "base": {},
    "walk_only": {"  mlstm_chunk_out_wgmma_kernel<<<":
                  "  if (false) mlstm_chunk_out_wgmma_kernel<<<"},
    "out_only": {"  mlstm_state_walk_wgmma_kernel<<<":
                 "  if (false) mlstm_state_walk_wgmma_kernel<<<"},
    "no_store": {"tma_store_3d(": "if (false) tma_store_3d("},
    "no_qc": {"Wgmma<128>::ss_t(": "if (false) Wgmma<128>::ss_t("},
    "loads_only": _NO_PRODUCTS,
}
KERNELS = {"flash_attention": ("flash_attention.cu", VARIANTS),
           "mlstm": ("mlstm.cu", MLSTM_VARIANTS)}
# (B, Hq, Hkv, S, D, Dv, window); causal, T = S
SHAPES = {"12 recurrentgemma-2b": (1, 10, 1, 3072, 256, 256, 2048),
          "12b deepseek-v2-lite-16b": (1, 16, 16, 2048, 192, 128, None),
          "12b minicpm3-4b": (1, 40, 40, 2048, 96, 64, None),
          "12c llama3.2-3b": (1, 24, 8, 2048, 128, 128, None)}


def build(kernel, names) -> None:
    """One library per variant, compiled concurrently; raises with the
    compiler's log if one fails or a substitution finds nothing."""
    from repro_torch.kernels import _build
    source, variants = KERNELS[kernel]
    src = (CSRC / source).read_text()
    procs = {}
    for name in names:
        d = OUT / kernel / name
        d.mkdir(parents=True, exist_ok=True)
        text = src
        for old, new in variants[name].items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (d / source).write_text(text)
        (d / "hopper_bf16.cuh").write_text(
            (CSRC / "hopper_bf16.cuh").read_text())
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *_build.ARCH, *_build.FLAGS, "-shared",
             str(d / source), "-o", str(d / "lib.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")


def run_mlstm(name) -> dict:
    """Device ms of the variant's mlstm_bf16 at row 13, called through the
    port's wrapper (its checks, padding and scratch) in place of the
    built library's entry."""
    import torch

    import chip_smoke
    from repro_torch.kernels import registry
    spec = registry.get("mlstm")
    fn = ctypes.CDLL(str(OUT / "mlstm" / name / "lib.so")).mlstm_bf16
    fn.argtypes = list(spec.argtypes)
    fn.restype = ctypes.c_int
    spec._bound["mlstm_bf16"] = fn
    dev = torch.device("cuda")
    sample = spec.sample(dev, torch.Generator(device=dev).manual_seed(0))
    total, split = chip_smoke.device_ms(spec.kernel, sample)
    return {"13 xlstm-350m": total,
            **{f"13 {k}": v for k, v in sorted(split.items())}}


def run(name) -> dict:
    """Device ms of the variant's entry at each shape."""
    import torch

    import chip_smoke
    from repro_torch.kernels.flash_attention import ops
    fn = ctypes.CDLL(str(OUT / "flash_attention" / name /
                         "lib.so")).flash_attention_bf16
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
    ap.add_argument("--kernel", choices=tuple(KERNELS),
                    default="flash_attention")
    ap.add_argument("--variants")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.run:
        runner = run_mlstm if args.kernel == "mlstm" else run
        print(json.dumps(runner(args.run)), flush=True)
        return 0
    import chip_smoke
    names = (args.variants.split(",") if args.variants
             else list(KERNELS[args.kernel][1]))
    build(args.kernel, names)
    card = chip_smoke.card_line()
    result = {}
    for name in names:
        p = subprocess.run([sys.executable, __file__, "--kernel",
                            args.kernel, "--run", name],
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
