"""One reader a per-layer metric, ``<metric>.py`` with ``read(ctx)``,
found by the metric's name in ``BENCHMARK.json``.  ``ctx`` carries what a
run measured (``cardbench.run.Context``); a reader that finds nothing to
read returns None and the metric is left out of the line.  Modules whose
names start with ``_`` hold the frozen formulas the readers share."""
