from .ops import coil_adjoint, coil_forward, coil_lincomb, plane_mult
from .ref import (coil_adjoint_ref, coil_forward_ref, coil_lincomb_ref,
                  plane_mult_ref)

__all__ = ["coil_forward", "coil_adjoint", "coil_lincomb", "plane_mult",
           "coil_forward_ref", "coil_adjoint_ref", "coil_lincomb_ref",
           "plane_mult_ref"]
