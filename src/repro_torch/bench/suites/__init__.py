"""Scenario definitions, one module per paper figure/table plus the
layers this repo added (gridding plans, the streaming engine, the
service, LM steps).  Importing this package registers everything with
``repro_torch.bench.registry`` (which is why it is not named
``scenarios``: the subpackage attribute would shadow
``repro_torch.bench.scenarios()``)."""

from . import (fig4, fig5, fig6, fig89, gridding, lm, serve,  # noqa: F401
               stream, table1)
