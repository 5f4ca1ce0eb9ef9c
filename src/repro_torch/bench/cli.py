"""A CLI entry point over the registry for a fixed set of figures:

    from repro_torch.bench.cli import figure_main
    main = figure_main("fig6,stream,gridding")

``figure_main`` returns a ``main(argv)`` that forwards to
``repro_torch.bench.run`` restricted to those figures, printing the table
without writing an artifact unless ``--out`` is given.
"""

from __future__ import annotations

import sys


def figure_main(figures: str):
    """Build a CLI entry point for a fixed set of figure names."""
    def main(argv=None) -> int:
        from .run import main as run_main
        argv = list(sys.argv[1:] if argv is None else argv)
        if not any(a == "--only" or a.startswith("--only=") for a in argv):
            argv += ["--only", figures]    # an explicit --only wins
        if not any(a == "--out" or a.startswith("--out=") for a in argv):
            argv += ["--out", "-"]
        return run_main(argv)
    return main
