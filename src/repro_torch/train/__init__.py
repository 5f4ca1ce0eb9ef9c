"""Training: the port of ``repro.train``.  AdamW and its schedule on dicts
of tensors (``optimizer``), the LM loss and the train step
(``trainer``), and int8 gradient compression over a communicator
(``grad_compress``).

The port's ``make_train_step`` returns the step alone, on one card or,
with a ``mesh``, on this rank's shards of a ``(data, model)`` mesh of
ranks (``make_train_state(mesh=)``, ``state_shardings``): the JAX
package's sharded step, gradients through the collectives of
``models.sharding``.
"""

from . import grad_compress, optimizer, trainer
from .optimizer import adamw_init, adamw_update, warmup_cosine
from .trainer import (lm_loss, make_grad_fn, make_train_state,
                      make_train_step, state_shardings)

__all__ = ["grad_compress", "optimizer", "trainer", "adamw_init",
           "adamw_update", "warmup_cosine", "lm_loss", "make_grad_fn",
           "make_train_state", "make_train_step", "state_shardings"]
