#!/usr/bin/env python3
"""Ablations of a kernel on the card: what bounds it.

    python3 scripts/flash_ablation.py [--kernel mlstm|rg_lru]
        [--variants base,...]

Builds copies of the kernel's source (``flash_attention.cu``, or
``mlstm.cu`` with ``--kernel mlstm``, ``rg_lru.cu`` with ``--kernel
rg_lru``, from ``src/repro_torch/kernels/csrc/``) with parts of its work
taken out, each into its own library under
``build/flash_ablation/`` (``nvcc`` for ``sm_90a``, all at once), and
times each copy's bf16 entry on the device (``torch.profiler``, as
``chip_smoke.py``'s kernels phase).  Flash attention is timed at the four
rows of PERF.md's kernel table: recurrentgemma-2b's windowed MQA prefill
(row 12), the two MLA prefills (12b) and llama3.2-3b's GQA prefill (12c);
the mLSTM at row 13, xlstm-350m's prefill (the spec's sample), through
the port's own wrapper with the copy's entry in place of the built one,
each of its two CUDA kernels' device ms beside the call's; the RG-LRU
scan the same way at row 14, recurrentgemma-2b's rglru layers at the
3072-token prompt (the spec's sample, float32), and in bf16 at the same
shape.
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

The RG-LRU scan:

- ``base``: the kernel as it is;
- ``no_store``: the TMA stores of h_t left out;
- ``no_fold``: each chunk enters with h0 alone: no predecessor's
  aggregate waited for or folded (the chain across chunks taken out);
- ``loads_only``: the stores and the fold left out and the walks' exp
  taken out: the tiles' loads, the sums and the barriers;
- ``loads_only_rows512``: that form on tiles of 512 bytes of lanes by 64
  steps (one part of 64 steps a lane in bf16), the wrapper's chunk with
  them;
- ``threads_loader``: the threads' loader on every shape (no TMA);
- ``timeline``: the kernel as it is, each block stamping the card's
  global timer (``%globaltimer``, ns) at its tile's start, after its
  parts' walks, after its predecessors' runs, after their fold into h0,
  after its re-walk and at its end, with its SM: the mean time of each
  span, the blocks an SM held at once, and when the blocks of every
  fourth chunk start and end.

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
# per-block stamps: (SM, start, parts walked, fold done, re-walked, end,
# ticket), read back by ``rg_lru_probe``
_STAMPS = {
    "namespace {\n\nconstexpr int kRowBytes":
        "namespace {\n__device__ unsigned long long g_stamps[65536 * 8];\n"
        "__device__ __forceinline__ unsigned long long stamp() {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
        "  return t;\n}\n\nconstexpr int kRowBytes",
    "  const int stages = (n + kStage - 1) / kStage;\n":
        "  const int stages = (n + kStage - 1) / kStage;\n"
        "  const unsigned long long q0 = stamp();\n",
    "    part_e[j][l] = end;\n  }\n  __syncthreads();\n":
        "    part_e[j][l] = end;\n  }\n  __syncthreads();\n"
        "  const unsigned long long q1 = stamp();\n",
    "    run_e[j][l] = end;\n  }\n  __syncthreads();\n":
        "    run_e[j][l] = end;\n  }\n  __syncthreads();\n"
        "  const unsigned long long q2 = stamp();\n",
    "    h_in[l] = h;\n  }\n  __syncthreads();\n":
        "    h_in[l] = h;\n  }\n  __syncthreads();\n"
        "  const unsigned long long q3 = stamp();\n",
    "  if (kTma) {\n    fence_proxy_async();":
        "  const unsigned long long q4 = stamp();\n"
        "  if (kTma) {\n    fence_proxy_async();",
    "      bulk_commit();\n      bulk_wait_read<0>();\n    }\n  }\n":
        "      bulk_commit();\n      bulk_wait_read<0>();\n    }\n  }\n"
        "  if (tid == 0) {\n    unsigned sm;\n"
        "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
        "    unsigned long long* pr = g_stamps + (ticket % 65536) * 8;\n"
        "    pr[0] = sm; pr[1] = q0; pr[2] = q1; pr[3] = q2; pr[4] = q3;\n"
        "    pr[5] = q4; pr[6] = stamp(); pr[7] = ticket;\n  }\n",
    'extern "C" {\n':
        'extern "C" {\nint rg_lru_probe(void* dst) {\n'
        '  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps,\n'
        '                                               sizeof(g_stamps)));\n'
        '}\n',
}
_NO_STORE = {"tma_store_3d(&tm_h,": "if (false) tma_store_3d(&tm_h,"}
_NO_FOLD = {"  const int r0 = min(j * q, c), r1 = min(r0 + q, c);":
            "  const int r0 = min(j * q, c), r1 = r0;"}
RG_LRU_VARIANTS = {
    "base": {},
    "no_store": _NO_STORE,
    "no_fold": _NO_FOLD,
    "timeline": _STAMPS,
    "loads_only": {
        **_NO_STORE, **_NO_FOLD,
        "        end = expf(la) * end + to_f32(b_s[i]);\n":
            "        end += to_f32(b_s[i]);\n",
        "        h = expf(to_f32(la_s[i])) * h + to_f32(b_s[i]);\n":
            "        h += to_f32(b_s[i]);\n"},
    "threads_loader": {"  if (tma) {\n    if (S < 1":
                       "  if (false) {\n    if (S < 1"},
}
# a tile shape on the loads_only form: 512 bytes of lanes by 64 steps (64
# KB, as the kernel's); the wrapper's chunk follows the kernel's
_ROWS = {"loads_only_rows512": (512, 64)}
for _name, (_row, _chunk) in _ROWS.items():
    RG_LRU_VARIANTS[_name] = {
        **RG_LRU_VARIANTS["loads_only"],
        "constexpr int kRowBytes = 256;": f"constexpr int kRowBytes = {_row};",
        "constexpr int kChunk = 128;": f"constexpr int kChunk = {_chunk};"}
RG_LRU_CHUNK = {name: chunk for name, (_, chunk) in _ROWS.items()}
KERNELS = {"flash_attention": ("flash_attention.cu", VARIANTS),
           "mlstm": ("mlstm.cu", MLSTM_VARIANTS),
           "rg_lru": ("rg_lru.cu", RG_LRU_VARIANTS)}
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


def run_rg_lru(name) -> dict:
    """Device ms of the variant's rg_lru at row 14 in float32 and at the
    same shape in bf16, called through the port's wrapper (its state,
    loader and checks) in place of the built library's entry; with the
    timeline variant, the stamps' summary of one more call at each."""
    import torch

    import chip_smoke
    from repro_torch.kernels import registry
    from repro_torch.kernels.rg_lru import ops
    ops.CHUNK = RG_LRU_CHUNK.get(name, ops.CHUNK)
    spec = registry.get("rg_lru")
    lib = ctypes.CDLL(str(OUT / "rg_lru" / name / "lib.so"))
    fn = lib.rg_lru
    fn.argtypes = list(spec.argtypes)
    fn.restype = ctypes.c_int
    spec._bound["rg_lru"] = fn
    dev = torch.device("cuda")
    sample = spec.sample(dev, torch.Generator(device=dev).manual_seed(0))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = tuple(a.to(dtype) for a in sample)
        label = f"14 recurrentgemma-2b {str(dtype)[6:]}"
        try:
            out[label] = chip_smoke.device_ms(spec.kernel, args)[0]
        except RuntimeError as err:      # a shape the variant cannot take
            print(f"{name} {label}: {err}", file=sys.stderr)
            continue
        if name == "timeline":
            out[label + " timeline"] = _timeline(lib, spec, args)
    return out


def _timeline(lib, spec, args) -> dict:
    """One call's block stamps: the spans' means (us), the blocks an SM
    held at once (count of SMs by that number), and the mean start and
    end (us from the first start) of every fourth chunk's blocks."""
    import numpy as np
    import torch

    from repro_torch.kernels.rg_lru.ops import CHUNK, lanes
    spec.kernel(*args)
    torch.cuda.synchronize()
    buf = np.zeros(65536 * 8, dtype=np.uint64)
    lib.rg_lru_probe.argtypes = [ctypes.c_void_p]
    if lib.rg_lru_probe(buf.ctypes.data):
        raise RuntimeError("rg_lru_probe failed")
    B, S, W = args[1].shape
    groups = B * -(-W // lanes(args[1].dtype))
    tiles = max(1, -(-S // CHUNK)) * groups
    sm, q0, q1, q2, q3, q4, q5, ticket = buf.reshape(-1, 8)[:tiles].astype(
        np.int64).T
    t0 = q0.min()
    held = []
    for s in np.unique(sm):
        ev = sorted([(t, 1) for t in q0[sm == s]] +
                    [(t, -1) for t in q5[sm == s]])
        now = most = 0
        for _, d in ev:
            now += d
            most = max(most, now)
        held.append(most)

    def us(x):
        return round(float(np.mean(x)) / 1e3, 3)
    chunk = ticket // groups
    return {"tiles": int(tiles), "span_us": (q5.max() - t0) / 1e3,
            "walk_us": us(q1 - q0), "runs_us": us(q2 - q1),
            "fold_us": us(q3 - q2), "rewalk_us": us(q4 - q3),
            "store_us": us(q5 - q4), "life_us": us(q5 - q0),
            "sms_by_blocks_held": np.bincount(held).tolist(),
            "chunks": {int(c): [us(q0[chunk == c] - t0),
                                us(q5[chunk == c] - t0)]
                       for c in np.unique(chunk)[::4]}}


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
        runner = {"mlstm": run_mlstm, "rg_lru": run_rg_lru}.get(
            args.kernel, run)
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
            if isinstance(ms, dict):
                print(f"{name} {shape}: {json.dumps(ms)} [{card}]",
                      flush=True)
            else:
                print(f"{name} {shape}: device {ms:.5f} ms [{card}]",
                      flush=True)
    print(json.dumps({"card": card, "device_ms": result}), flush=True)
    return 0 if all(result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
