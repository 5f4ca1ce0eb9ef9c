"""The work one NLINV frame needs, counted from the configuration's shapes
and the CG iterations the frame ran: the yardstick of ``frame_mfu``.

Every operator application (G, DG or DG^H) takes 2 J centered 2-D FFTs of
the grid, each plane read once and written once (the centering is part
of the transform), at 5 N log2 N flops a transform of N points.  Besides
the FFTs the frame reads and writes, as 8-byte complex elements of the
state S = (J + 1) grid^2 (a J-coil stack and the image) and 4-byte real
planes:

  each CG iteration  the update (p, Ap, x, r read; x, r written) and the
                     direction (r, p read; p written): 9 S; DG and DG^H
                     read the Newton point's coils (J planes) and rho0
                     (one plane) once each, and six real planes (the
                     weight, FOV and mask in each);
  each Newton step   the coils of the Newton point written once (J
                     planes), the residual y - G(x) (3 J planes), the
                     right-hand side (4 S) and the step x + dx (3 S).

The count is the same whatever implements the work, so a change that
fuses or removes a pass leaves the yardstick where it is.  Its flops
count the FFTs alone: the pointwise flops are far below the bytes'
bound on this card.
"""

from __future__ import annotations

import math

from ._peaks import F32_FLOPS, bound_s


def frame_work(grid: int, ncoils: int, cg_counts) -> tuple[float, float]:
    """(flops, bytes) of one frame whose Newton steps ran ``cg_counts``
    CG iterations each."""
    P = grid * grid
    plane, real = 8 * P, 4 * P
    S = (ncoils + 1) * plane
    app_bytes = 2 * ncoils * 2 * plane
    app_flops = 2 * ncoils * 5 * P * math.log2(P)
    flops = nbytes = 0.0
    for iters in cg_counts:
        apps = 2 + 2 * iters
        flops += apps * app_flops
        nbytes += apps * app_bytes
        nbytes += ncoils * plane + 3 * ncoils * plane + 7 * S
        nbytes += iters * (9 * S + 2 * (ncoils * plane + plane) + 6 * real)
    return flops, nbytes


def frames_bound_s(grid: int, ncoils: int, frames) -> float:
    """Σ over ``frames`` (each a list of CG counts) of the frame's bound."""
    return sum(bound_s(*frame_work(grid, ncoils, c), F32_FLOPS)
               for c in frames)
