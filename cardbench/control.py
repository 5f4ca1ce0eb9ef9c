"""The readings a comparison's limit is set from, on the card at a cell's
own size:

    python3 -m cardbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds <s>

runs the cell once a seed in one process (the benchmark's own path:
set-up, the window at the cell's load, the comparison), and on the
control seeds also holds the control (the reference stored in bfloat16,
in the program's place) against the reference on the same frames.
Prints a line a seed and, last, one JSON object: the program's largest
reading (the lower end of a limit) and the control's smallest (its
upper end).  The benchmark's runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import check
from . import run as bench


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    man = bench.manifest()
    sys.path.insert(0, str(bench.ROOT / "src"))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    program, control = {}, {}
    for seed in seeds + sorted(ctrl - set(seeds)):
        line, ctx = bench.run_cell(man, args.workload, seed, args.seconds,
                                   False, control=seed in ctrl)
        got = check.readings(ctx.compared)
        program[seed] = got["frame_rel_err"]
        msg = (f"seed {seed}: program {got['frame_rel_err']:.6e} over "
               f"{got['frames_compared']} frames (worst "
               f"{got.get('worst_frame')}), correct {line['correct']}, "
               f"frames {ctx.frames}")
        if seed in ctrl:
            c = [e for _, e in ctx.control_compared]
            control[seed] = max(c)
            msg += f"; control min {min(c):.6e} max {max(c):.6e}"
        print(msg, flush=True)
    out = {"workload": args.workload,
           "program_max": max(program.values()),
           "control_min": min(control.values()) if control else None,
           "program": program, "control": control,
           "limit": check.LIMITS["frame_rel_err"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
