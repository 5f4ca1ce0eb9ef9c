"""Training: the port of ``repro.train``.  AdamW and its schedule on dicts
of tensors (``optimizer``), the LM loss and the train step
(``trainer``), and int8 gradient compression over a communicator
(``grad_compress``).

The port's ``make_train_step`` returns the step alone and runs it on one
card.  The partition specs and their placement on ranks came with
tensor-parallel serving (``models.sharding``); the JAX package's
``state_shardings`` and the step's ``build`` (the sharded train step)
wait in ROADMAP Queue 1, item 3.
"""

from . import grad_compress, optimizer, trainer
from .optimizer import adamw_init, adamw_update, warmup_cosine
from .trainer import lm_loss, make_train_state, make_train_step

__all__ = ["grad_compress", "optimizer", "trainer", "adamw_init",
           "adamw_update", "warmup_cosine", "lm_loss", "make_train_state",
           "make_train_step"]
