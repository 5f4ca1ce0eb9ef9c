"""Tables of the port's dry run from ``results/dryrun_torch/*.json``, the
port of ``repro/launch/report.py``.

  PYTHONPATH=src python -m repro_torch.launch.report \\
      [--dir results/dryrun_torch]

Both tables are modelled from the H100's constants of
``core.runtime.HW``, not measured.  ``fits`` holds a rank's peak (argument
+ temp + output - alias) against the card's memory, ``HW["hbm_bytes"]``,
where the JAX module holds it against a v5e's 16 GiB.  The multi-pod
table gives the pod axis's wire bytes a rank, which cross the network
between pods.
"""

from __future__ import annotations

import argparse
import json
import pathlib

from ..configs import ARCH_IDS, SHAPES
from ..core.runtime import HW

SINGLE, MULTI = "h100x32x8", "h100x2x32x8"


def load(dir_):
    recs = {}
    for fn in sorted(pathlib.Path(dir_).glob("*.json")):
        d = json.loads(fn.read_text())
        mesh = d.get("mesh_name", "?")
        recs[(d["arch"], d["shape"], mesh)] = d
    return recs


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def per_device(mem) -> int:
    return (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"])


def roofline_table(recs, mesh=SINGLE):
    lines = [
        "| arch | shape | t_comp ms | t_mem ms | t_coll ms | dominant | "
        "GFLOP/dev | model/counted | HBM GiB/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = recs.get((arch, shape, mesh))
            if r is None:
                lines.append(f"| {arch} | {shape} | - | - | - | MISSING "
                             "| | | | |")
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | - | - | - | "
                             f"SKIP ({r['skipped'][:40]}) | | | | |")
                continue
            t = r["roofline"]
            dev = per_device(r["memory"])
            fits = "Y" if dev < HW["hbm_bytes"] else "N"
            lines.append(
                f"| {arch} | {shape} | {t['t_compute_s']*1e3:.2f} | "
                f"{t['t_memory_s']*1e3:.2f} | {t['t_collective_s']*1e3:.2f} | "
                f"{t['dominant']} | {r['flops']/1e9:.1f} | "
                f"{r['model_vs_counted']:.2f} | {dev/2**30:.2f} | {fits} |")
    return "\n".join(lines)


def multipod_table(recs, mesh=MULTI):
    lines = [
        "| arch | shape | traced | arg GiB | temp GiB | pod wire B/dev |",
        "|---|---|---|---|---|---|",
    ]
    for arch in ARCH_IDS:
        for shape in SHAPES:
            r = recs.get((arch, shape, mesh))
            if r is None:
                lines.append(f"| {arch} | {shape} | MISSING | | | |")
                continue
            if "skipped" in r:
                lines.append(f"| {arch} | {shape} | SKIP | | | |")
                continue
            mem = r["memory"]
            pod = r["collectives"]["pod_wire_bytes"]
            lines.append(
                f"| {arch} | {shape} | OK ({r['cell_s']}s) | "
                f"{fmt_bytes(mem['argument_bytes'])} | "
                f"{fmt_bytes(mem['temp_bytes'])} | {pod:.2e} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default=SINGLE)
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(f"## Single-pod roofline (32x8 H100s), modelled on {HW['name']} "
          f"at {HW['power_limit_w']:.0f} W (core.runtime.HW)\n")
    print(roofline_table(recs, args.mesh))
    print("\n## Multi-pod pass (2x32x8 H100s), modelled\n")
    print(multipod_table(recs))


if __name__ == "__main__":
    main()
