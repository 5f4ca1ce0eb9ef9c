"""Launchers: the port of ``repro.launch``'s training launcher
(``launch.train``).  The rest of the JAX package's ``launch`` (serving
launcher, mesh, cells, dry-run costing, roofline, reports) waits in
ROADMAP Queue 1, item 5."""
