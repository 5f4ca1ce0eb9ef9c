"""Launchers: the port of ``repro.launch``'s training launcher
(``launch.train``), its serving launcher (``launch.serve``) and its mesh
helpers (``launch.mesh``).  The rest of the JAX package's ``launch`` (the
dry-run cells, costing, roofline and reports, and the v5e pod's
``make_production_mesh``) waits in ROADMAP Queue 1."""
