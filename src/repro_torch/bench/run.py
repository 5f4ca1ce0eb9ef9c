"""Benchmark sweep runner.

  PYTHONPATH=src python -m repro_torch.bench.run [--size tiny|paper]
      [--devices 1,4] [--only fig4,stream,...] [--out PATH]
      [--sweep SIZE:FIG,FIG ...] [--iters N] [--warmup N] [--list]
      [--device cuda|cpu] [--shared-card] [--timeout S]

``--sweep SIZE:FIGURES`` (repeatable) runs several (size, figure-set)
combinations in ONE artifact — e.g. ``--sweep tiny:fig4,fig5 --sweep
paper:fig5``.  When present it replaces ``--size``/``--only``.

The parent process never runs a scenario itself: for each requested
rank count N it starts one child, N rank processes (``core.run_ranks``),
each of which builds ``env.subgroup(N)`` and runs every scenario of
every (size, figures) job; rank 0's timings and extras are the child's
result, and cross the process boundary as plain Python, never tensors.
The parent merges the children's runs, computes per-scenario speed-ups
vs the 1-rank runs, and writes one schema-versioned artifact
(``repro_torch.bench.artifact``).
``--out -`` (the default) prints the table only.

The ranks run on the card unless ``--device cpu``; without a card and
without ``--device cpu`` the run fails.  Each rank has a card of its own
(NCCL) unless ``--shared-card`` puts every rank on one card (gloo, the
collectives staged through the host): the artifact's
``host.shared_card`` says which, so a shared card's ``speedup_vs_1dev``
is never read as the scaling of N cards.  On the CPU the ranks use gloo.

With one rank a failing scenario is reported and the sweep goes on (exit
1, nothing written); with N > 1 ranks it fails its child at once, so
that no rank waits in a collective for a rank that has given up.  Side
artifacts (latency reports, each child's kernel launch counts) go to
``--out-dir``, by default under the ignored ``build/``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT_DIR = REPO / "build" / "bench" / "out"
# lm (per-architecture LM steps) is opt-in: it is paper-size only and far
# heavier than the paper-figure scenarios the trajectory tracks.
DEFAULT_FIGURES = ("fig4", "fig5", "fig6", "fig89", "gridding", "serve",
                   "stream", "table1")
DEFAULT_TIMEOUT_S = 1800.0


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="repro_torch.bench.run",
        description="run registered benchmark scenarios, emit an artifact")
    ap.add_argument("--size", choices=("tiny", "paper"), default="tiny")
    ap.add_argument("--quick", action="store_true",
                    help="alias for --size tiny")
    ap.add_argument("--devices", default="1,4",
                    help="comma-separated rank counts (default 1,4)")
    ap.add_argument("--only", default=",".join(DEFAULT_FIGURES),
                    help="comma-separated figure names; 'all' = every "
                         "registered figure (default: paper figures, no lm)")
    ap.add_argument("--out", default="-",
                    help="artifact path; '-' = print only (default — a "
                         "partial sweep must never clobber a kept artifact "
                         "by accident)")
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT_DIR),
                    help="directory for side artifacts (latency reports, "
                         "kernel launch counts)")
    ap.add_argument("--sweep", action="append", default=[],
                    metavar="SIZE:FIGURES",
                    help="repeatable SIZE:FIG,FIG spec; when given, "
                         "replaces --size/--only and every spec runs at "
                         "every --devices count into one artifact")
    ap.add_argument("--iters", type=int, default=None,
                    help="steady-state samples per scenario (default by size)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="warmup calls incl. the first call (default by size)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where the ranks run (default: the card)")
    ap.add_argument("--shared-card", action="store_true",
                    help="put every rank on one card (gloo) instead of a "
                         "card each (NCCL)")
    ap.add_argument("--timeout", type=float, default=DEFAULT_TIMEOUT_S,
                    help="seconds one child's ranks may take, every "
                         "collective wait included (default %(default)s)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    args = ap.parse_args(argv)
    if args.quick:
        args.size = "tiny"
    return args


def _figures(only: str):
    if only.strip().lower() == "all":
        return None
    return tuple(f.strip() for f in only.split(",") if f.strip())


def _jobs(args) -> list[tuple[str, str]]:
    """The (size, only) combinations this sweep runs, each by the child
    of every rank count.  Default: the single --size/--only pair."""
    if not args.sweep:
        return [(args.size, args.only)]
    jobs = []
    for spec in args.sweep:
        size, sep, figs = spec.partition(":")
        size = size.strip()
        if not sep or size not in ("tiny", "paper") or not figs.strip():
            raise SystemExit(f"repro_torch.bench: bad --sweep spec {spec!r} "
                             "(want SIZE:FIG,FIG with SIZE tiny|paper)")
        jobs.append((size, figs.strip()))
    return jobs


def _sampling(size: str, iters, warmup) -> dict:
    from .harness import SIZE_DEFAULTS
    s = dict(SIZE_DEFAULTS[size])
    if iters is not None:
        s["iters"] = iters
    if warmup is not None:
        s["warmup"] = warmup
    return s


def _stamp(where: str, what: str, since: float) -> None:
    """A progress line on stderr: seconds of wall clock since ``since``
    (``time.time()``, comparable across the rank processes)."""
    print(f"  [{where}] {what} at {time.time() - since:.2f} s",
          file=sys.stderr, flush=True)


def card_line(ncards: int = 1) -> str:
    """The cards' names and power limits as ``nvidia-smi`` reads them
    (``name, power.limit`` of the first ``ncards`` cards)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(out.stdout.strip().splitlines()[:ncards])


# ---------------------------------------------------------------------------
# child: the ranks of one rank count, real measurements
# ---------------------------------------------------------------------------

def _child_rank(env, child: dict) -> dict | None:
    """One rank of a child: every scenario of every job of ``child`` on
    ``env.subgroup(N)``.  Rank 0 returns the runs, the failures (one
    rank only: a failure on N ranks raises), the host calibration and
    its kernel launch counts, which it also writes to ``out_dir``; the
    other ranks return None."""
    from ..kernels import registry as kreg
    from .harness import BenchContext, calibrate
    from .registry import scenarios

    n = child["devices"]
    out_dir = pathlib.Path(child["out_dir"])
    comm = env.subgroup(n)
    lead = env.rank == 0
    if lead:
        _stamp(f"{n}d", "ranks ready", child["t_start"])
    kreg.reset_launches()
    runs, failures = [], []
    for size, only, sampling in child["jobs"]:
        ctx = BenchContext(size=size, devices=n, comm=comm, out_dir=out_dir,
                           device=env.device, **sampling)
        for key, sc in scenarios(figures=_figures(only)).items():
            if size not in sc.sizes or n not in sc.devices:
                continue
            t0 = time.perf_counter()
            if n == 1:
                try:
                    res = dict(sc.fn(ctx))
                except Exception:
                    # one broken scenario must not void the rest of the
                    # sweep; the parent fails the run but still reports
                    # what measured
                    traceback.print_exc()
                    failures.append(f"{key}@d{n}@{size}")
                    continue
            else:
                res = dict(sc.fn(ctx))
            runs.append({"scenario": key, "figure": sc.figure, "devices": n,
                         "size": size, **res})
            if lead:
                print(f"  [{n}d/{size}] {key} {time.perf_counter() - t0:.2f} "
                      f"s", file=sys.stderr, flush=True)
    if not lead:
        return None
    _stamp(f"{n}d", "scenarios done", child["t_start"])
    launches = {k: v for k, v in kreg.launches().items() if v}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"kernel_launches_d{n}.json").write_text(
        json.dumps(launches, indent=2, sort_keys=True) + "\n")
    return {"calibration_ms": calibrate(), "runs": runs,
            "failures": failures, "launches": launches}


# ---------------------------------------------------------------------------
# parent: sweep rank counts in rank processes, merge, write artifact
# ---------------------------------------------------------------------------

def _backend(ndev: int, device, shared_card: bool) -> str | None:
    """No process group for one rank; gloo on the CPU or on a shared
    card; NCCL when every rank has a card of its own."""
    if ndev == 1:
        return None
    return "gloo" if device.type == "cpu" or shared_card else "nccl"


def _run_child(args, device, ndev: int, jobs) -> dict | None:
    """The child of one rank count: ``ndev`` rank processes that run every
    job; rank 0's result, or None when the child failed."""
    from ..core.launch import run_ranks
    child = {"devices": ndev, "out_dir": args.out_dir, "t_start": time.time(),
             "jobs": [(size, only, _sampling(size, args.iters, args.warmup))
                      for size, only in jobs]}
    try:
        ranks = run_ranks(_child_rank, ndev,
                          backend=_backend(ndev, device, args.shared_card),
                          device=device.type,
                          shared_card=args.shared_card, args=(child,),
                          timeout=args.timeout)
    except (RuntimeError, TimeoutError) as e:
        print(f"repro_torch.bench: {ndev}-rank child failed: {e}",
              file=sys.stderr)
        return None
    _stamp(f"{ndev}d", "ranks ended", child["t_start"])
    return ranks[0]


def _host(device, counts, shared_card: bool, sizes) -> dict:
    import torch
    host = {"platform": "gpu" if device.type == "cuda" else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "device_count": counts[0],
            "device_counts": counts, "shared_card": shared_card,
            "size": ",".join(sizes)}
    if device.type == "cuda":
        host["card"] = card_line(1 if shared_card else max(counts))
    return host


def _format_table(art: dict) -> str:
    head = f"{'scenario':<38} {'dev':>3} {'size':>5} {'compile_ms':>11} " \
           f"{'steady_ms':>10} {'speedup':>8}"
    lines = [head, "-" * len(head)]
    for key in sorted(art["scenarios"]):
        r = art["scenarios"][key]
        sp = r.get("speedup_vs_1dev")
        lines.append(
            f"{r['scenario']:<38} {r['devices']:>3} {r['size']:>5} "
            f"{r['compile_ms']:>11.3f} {r['steady_ms']:>10.3f} "
            f"{sp if sp is not None else '-':>8}")
    return "\n".join(lines)


def main(argv=None) -> int:
    t_main = time.time()
    args = _parse_args(argv)

    if args.list:
        from .registry import scenarios
        for key, sc in scenarios(figures=_figures(args.only)).items():
            print(f"{key:<30} sizes={','.join(sc.sizes)} "
                  f"devices={','.join(map(str, sc.devices))}  {sc.doc}")
        return 0

    from .artifact import make_artifact, write_artifact
    from .registry import figure_names

    jobs = _jobs(args)
    for _, only in jobs:
        figs = _figures(only)
        unknown = set(figs or ()) - set(figure_names())
        if unknown:
            raise SystemExit(f"repro_torch.bench: unknown figure(s) "
                             f"{sorted(unknown)}; registered: "
                             f"{list(figure_names())}")
    counts = [int(d) for d in args.devices.split(",") if d.strip()]
    if not counts or min(counts) < 1:
        raise SystemExit("repro_torch.bench: --devices must name rank "
                         "counts >= 1")

    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"repro_torch.bench: {e}") from None

    _stamp("parent", "children start", t_main)
    partials, failures = [], []
    for ndev in counts:
        # a failed child must not void the others' results
        p = _run_child(args, device, ndev, jobs)
        if p is None:
            failures.append(f"<{ndev}-rank child>")
            continue
        partials.append(p)
        failures += p["failures"]

    runs = [r for p in partials for r in p["runs"]]
    if not runs:
        raise SystemExit("repro_torch.bench: the sweep produced no runs "
                         "(every scenario failed or none matched the "
                         f"requested sizes / --devices {args.devices})")
    sizes = list(dict.fromkeys(size for size, _ in jobs))
    host = _host(device, counts, args.shared_card, sizes)
    # best (fastest) reference across children = the machine's speed
    # with the least neighbor interference during this sweep
    cal = min(p["calibration_ms"] for p in partials)
    art = make_artifact(runs, host=host, calibration_ms=cal)
    _stamp("parent", "artifact made", t_main)
    print(_format_table(art))
    if failures:
        # never persist a partial sweep: a baseline missing the failed
        # rows would silently drop them from the regression gate
        print(f"FAILED scenarios: {failures}", file=sys.stderr)
        if args.out != "-":
            print(f"not writing {args.out} (incomplete sweep)",
                  file=sys.stderr)
        return 1
    if args.out != "-":
        path = write_artifact(args.out, art)
        print(f"wrote {path} ({len(runs)} runs)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
