"""Launchers: the port of ``repro.launch``.  The training launcher
(``launch.train``), the serving launcher (``launch.serve``), the mesh
helpers and the dry production mesh (``launch.mesh``), and the dry run:
one rank's step of every (arch x shape x mesh) cell traced on the meta
device (``launch.cells``, ``launch.costing``), priced by the ring model
against the H100's constants (``launch.roofline``), swept by
``python -m repro_torch.launch.dryrun`` and tabled by ``python -m
repro_torch.launch.report``."""
