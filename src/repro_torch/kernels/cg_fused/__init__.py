from .ops import cg_update, xpby_dot
from .ref import (cg_update_ref, row_sq_norm, sq_norm, xpby_dot_ref,
                  xpby_ref)

__all__ = ["cg_update", "xpby_dot", "cg_update_ref", "row_sq_norm",
           "sq_norm", "xpby_dot_ref", "xpby_ref"]
