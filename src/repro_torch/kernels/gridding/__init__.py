from .ops import (Interp, cell_index, degrid, degrid_plain, grid_adjoint,
                  grid_adjoint_plain, interp_matrices, interp_taps,
                  radial_trajectory)
from .ref import degrid_ref, grid_ref

__all__ = ["Interp", "cell_index", "degrid", "degrid_plain", "grid_adjoint",
           "grid_adjoint_plain", "interp_matrices", "interp_taps",
           "radial_trajectory",
           "degrid_ref", "grid_ref"]
