"""Run one benchmark cell once and print its result line.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Everything a cell needs is found by name:
the cell in ``BENCHMARK.json``, its configuration file, its traffic file
(``cardbench/workloads/<traffic>.json``), the entry that file names
(``cardbench/entries/<entry>.py``) and one reader a per-layer metric
(``cardbench/metrics/<metric>.py``).  The entry builds the program from
the seed, warms every shape the window uses (set-up), drives the window,
and compares what it delivered with the plain reference once the window
has closed.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(with ``--trace 1`` also ``busy_s`` and ``window_s``), ``breakdown`` with
``--trace 1``, and last ``checks``, each number compared beside its
limit, which also close standard error.

The run needs the CUDA cards the cell asks for and the program
(``src/repro_torch``) in the checkout; without either it prints no
result and exits with 2.  It exits with 3 if JAX or the JAX package was
imported by the time the window closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from . import check  # noqa: E402
from . import trace as tr  # noqa: E402
from .data import traffic as traffic_files  # noqa: E402
from .metrics._kernels import unknown_port_kernels  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names the process must not hold: JAX and the JAX
# package the port was made from (``repro_torch`` is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Context:
    """One run of one cell: what it was asked, and what it measured."""

    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    chips: int
    t0: float = T0
    # measured by the entry
    setup_s: float = 0.0
    window_s: float = 0.0
    frames: int = 0
    attempted: int = 0
    failed: int = 0
    latency_ms: list = dataclasses.field(default_factory=list)
    cg_frames: list = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0
    # the traced stretch (--trace 1)
    trace_record: dict | None = None
    traced_frames: int = 0
    kernels: dict | None = None
    # the comparison with the reference: [(label, relative error), ...]
    compared: list = dataclasses.field(default_factory=list)
    # the control held against the reference on the same frames (set by
    # ``cardbench.control`` only; the benchmark's runs do not run it)
    control: bool = False
    control_compared: list = dataclasses.field(default_factory=list)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells: "
                     f"{[w['name'] for w in man['workloads']]}")


def config_of(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def end_to_end_of(man: dict, cell: str) -> list[dict]:
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(man: dict, cell: str) -> list[dict]:
    names = {m["name"] for m in end_to_end_of(man, cell)}

    def reported(m):
        if "workloads" in m:
            return cell in m["workloads"]
        return m["moves"] in names

    return [m for m in man["per_layer"] if reported(m)]


def reader(name: str):
    """``cardbench/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"cardbench.metrics.{name.replace('.', '_')}", path,
        submodule_search_locations=None)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "cardbench.metrics"
    spec.loader.exec_module(mod)
    return mod.read


def entry(name: str):
    return importlib.import_module(f"cardbench.entries.{name}")


def forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def end_to_end(ctx: Context) -> dict:
    lat = np.asarray(ctx.latency_ms, np.float64)
    out = {"setup_s": ctx.setup_s}
    if ctx.window_s > 0:
        out["frames_per_s"] = ctx.frames / ctx.window_s
    if lat.size:
        out["frame_latency_p95_ms"] = float(np.percentile(lat, 95))
    return out


def power_limit() -> str:
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread ({e.__class__.__name__})"
    return "; ".join(got.stdout.strip().splitlines()) or "unread"


def run_cell(man: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: dict | None = None,
             traffic: dict | None = None,
             control: bool = False) -> tuple[dict, Context]:
    """Run cell ``name`` once: (result line, context).  ``config`` and
    ``traffic`` stand in for the cell's files (the CPU tests run the
    same path at a tiny size); ``control`` also holds the control
    against the reference (``ctx.control_compared``)."""
    cell = cell_of(man, name)
    config = config_of(man, cell["config"]) if config is None else config
    traffic = traffic_files.load(cell["traffic"]) if traffic is None \
        else traffic
    ctx = Context(name=name, config=config, traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  chips=cell["chips"], control=control)
    entry(traffic["entry"]).run(ctx)
    got = check.readings(ctx.compared)
    ok, checks = check.verdict(got)
    ok = ok and ctx.failed == 0
    units = {m["name"]: m["unit"] for m in man["end_to_end"]
             + man["per_layer"]}
    if trace:
        values = {}
        for m in per_layer_of(man, name):
            v = reader(m["name"])(ctx)
            if v is not None:
                values[m["name"]] = v
    else:
        e2e = end_to_end(ctx)
        values = {m["name"]: e2e[m["name"]]
                  for m in end_to_end_of(man, name) if m["name"] in e2e}
    line = {"correct": bool(ok), "attempted": ctx.attempted,
            "failed": ctx.failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": device_info(ctx)}
    if trace and ctx.trace_record is not None:
        line["breakdown"] = {
            "device_ops": tr.device_ops(ctx.trace_record),
            "idle_gaps": tr.gaps_by_host(ctx.trace_record)}
    if ctx.trace_record is not None and ctx.kernels is not None:
        unknown = dict(ctx.kernels["unknown"], **unknown_port_kernels(
            ctx.trace_record["device"]))
        if unknown:
            line["unknown_kernels"] = unknown
    line["window"] = {"seconds": ctx.window_s, "frames": ctx.frames,
                      "latency_samples": len(ctx.latency_ms),
                      "worst_compared": got.get("worst_frame")}
    line["checks"] = checks
    return line, ctx


def device_info(ctx: Context) -> dict:
    import torch
    if ctx.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": ctx.memory_peak_bytes}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": ctx.chips,
                "memory_peak_bytes": ctx.memory_peak_bytes}
    if ctx.trace and ctx.trace_record is not None:
        info["busy_s"] = tr.busy_us(ctx.trace_record) / 1e6
        info["window_s"] = tr.window_us(ctx.trace_record) / 1e6
    return info


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--trace-out", default=None,
                   help="also write the traced stretch's record here")
    args = p.parse_args(argv)
    man = manifest()
    cell = cell_of(man, args.workload)
    program = ROOT / "src" / "repro_torch"
    if not program.is_dir():
        print(f"cardbench: the program ({program}) is not in this "
              f"checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: cell {args.workload} needs {cell['chips']} CUDA "
              f"card(s); available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    line, ctx = run_cell(man, args.workload, args.seed, args.seconds,
                         bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"cardbench: the process imported {leaked}; the benchmark "
              f"runs the PyTorch port only", file=sys.stderr)
        return 3
    if args.trace_out and ctx.trace_record is not None:
        rec = dict(ctx.trace_record, frames=ctx.traced_frames,
                   kernels=ctx.kernels, cg_frames=ctx.cg_frames,
                   latency_ms=ctx.latency_ms)
        Path(args.trace_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.trace_out).write_text(json.dumps(rec))
    print(f"cardbench: set-up {ctx.setup_s:.3f} s, window {ctx.window_s:.3f}"
          f" s, {ctx.frames} frames, whole run "
          f"{time.perf_counter() - T0:.3f} s", file=sys.stderr)
    if ctx.latency_ms:
        q = np.percentile(np.asarray(ctx.latency_ms), [0, 50, 90, 95, 99,
                                                       100])
        print("cardbench: latency ms min/p50/p90/p95/p99/max "
              + " / ".join(f"{v:.3f}" for v in q), file=sys.stderr)
    print(f"cardbench: widest gap at {line['window']['worst_compared']}",
          file=sys.stderr)
    print(f"card: {power_limit()}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
