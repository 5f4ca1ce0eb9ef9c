"""The dry run of the port: every (architecture x input shape x mesh) cell
traced as one rank of an H100 production mesh on the meta device, with
no process, no card and no allocation.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both \\
      --out results/dryrun_torch

The port of ``repro/launch/dryrun.py``.  The JAX module compiles each
cell on 512 placeholder host devices and reads XLA's cost and memory
analyses; the port traces one rank's step (``launch.costing``) on the
first and the last rank of the mesh, whose collective records must agree
entry for entry (the port's proof that the sharding is coherent).  It
yields the rank's flops, the modelled HBM bytes, the wire bytes of each
collective priced by its link (NVLink inside a node, the network across
nodes), its peak memory against the card's (``core.runtime.HW``), and the
roofline terms.  Every number is modelled from the H100's constants of
``core.runtime.HW``; none is measured.  It writes one JSON record a cell
(the JAX module's keys where they mean the same thing; ``model_vs_hlo``
is ``model_vs_counted``), prints each cell's seconds and exits 1 on any
failure.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

from ..configs import ARCH_IDS, SHAPES, get_config
from ..core.runtime import HW
from .cells import model_flops
from .costing import cell_cost
from .mesh import make_production_mesh
from .roofline import collective_summary, roofline_terms

MESH_NAMES = {False: "h100x32x8", True: "h100x2x32x8"}


def run_cell(arch, shape, multi_pod, mesh_name, *, act_sp=True,
             policy="fsdp_tp"):
    """One cell's record: the cost of the first rank's step, its roofline
    terms and the seconds the two ranks' traces took."""
    t0 = time.time()
    cost = cell_cost(arch, shape, lambda r: make_production_mesh(
        multi_pod=multi_pod, rank=r), act_sp=act_sp, policy=policy)
    if "skipped" in cost:
        return {"arch": arch, "shape": shape, "mesh_name": mesh_name,
                "skipped": cost["skipped"]}
    meta = cost["meta"]
    mem = cost["memory"]
    size = math.prod(meta["mesh"].values())
    mf = model_flops(arch, shape)
    dtype = "float32" if get_config(arch).compute_dtype == "float32" \
        else "bfloat16"
    terms = roofline_terms(cost, cost["colls"], dtype=dtype)
    colls = collective_summary(cost["colls"])
    rec = {**meta, "mesh_name": mesh_name, "memory": mem,
           "peak_bytes": cost["peak_bytes"],
           "fits": cost["peak_bytes"] < HW["hbm_bytes"],
           "flops": cost["flops"], "flops_counted": cost["flops_counted"],
           "kernel_flops": cost["kernel_flops"],
           "kernels": cost["kernels"], "bytes": cost["bytes"],
           "slstm_analytic_flops": cost["slstm_analytic_flops"],
           "hbm_model": cost["hbm_model"], "collectives": colls,
           "roofline": {k: v for k, v in terms.items()
                        if k != "collectives"},
           **mf,
           "model_vs_counted": (mf["model_flops"] / size) /
           max(cost["flops"], 1.0),
           "ranks_traced": cost["ranks_traced"],
           "n_collectives": len(cost["record"]),
           "trace_s": round(cost["trace_s"], 2),
           "modelled_on": f"{HW['name']} at {HW['power_limit_w']:.0f} W "
                          f"(core.runtime.HW)"}
    gib = 2 ** 30
    print(f"  memory: arg={mem['argument_bytes'] / gib:.2f}GiB "
          f"temp={mem['temp_bytes'] / gib:.2f}GiB "
          f"out={mem['output_bytes'] / gib:.2f}GiB "
          f"alias={mem['alias_bytes'] / gib:.2f}GiB "
          f"peak={cost['peak_bytes'] / gib:.2f}GiB fits={rec['fits']}")
    print(f"  flops={cost['flops']:.3e} (kernels {cost['kernel_flops']:.3e})"
          f" bytes={cost['bytes']:.3e} nvlink={colls['nvlink_wire_bytes']:.3e}B"
          f" net={colls['net_wire_bytes']:.3e}B"
          + (f" pod={colls['pod_wire_bytes']:.3e}B" if multi_pod else ""))
    print(f"  roofline: compute={terms['t_compute_s'] * 1e3:.2f}ms "
          f"memory={terms['t_memory_s'] * 1e3:.2f}ms "
          f"collective={terms['t_collective_s'] * 1e3:.2f}ms "
          f"dominant={terms['dominant']}")
    rec["cell_s"] = round(time.time() - t0, 1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-act-sp", action="store_true",
                    help="disable sequence-parallel activation sharding")
    ap.add_argument("--policy", default="fsdp_tp",
                    choices=["fsdp_tp", "pure_fsdp"])
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failures = []
    t_all = time.time()
    for multi in meshes:
        mesh_name = MESH_NAMES[multi]
        for arch in archs:
            for shape in shapes:
                tag = f"_{args.tag}" if args.tag else ""
                fn = out / f"{arch}__{shape}__{mesh_name}{tag}.json"
                if fn.exists() and not args.force:
                    print(f"[skip existing] {fn.name}")
                    continue
                print(f"[{mesh_name}] {arch} x {shape}", flush=True)
                try:
                    rec = run_cell(arch, shape, multi, mesh_name,
                                   act_sp=not args.no_act_sp,
                                   policy=args.policy)
                    fn.write_text(json.dumps(rec, indent=1))
                    if "skipped" in rec:
                        print(f"  SKIPPED: {rec['skipped']}")
                    else:
                        print(f"  cell_s={rec['cell_s']}", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append((mesh_name, arch, shape, repr(e)))
                    print("  FAILED:", repr(e))
                    traceback.print_exc(limit=3)
    print(f"\nsweep_s={time.time() - t_all:.1f}")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested cells OK")


if __name__ == "__main__":
    main()
