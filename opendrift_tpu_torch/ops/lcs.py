"""Finite-time Lyapunov exponents (Cauchy-Green eigenvalues).

The port's copy of ``opendrift_tpu/ops/lcs.py`` (host numpy).  A
vectorised re-implementation of the reference's FTLE function
(reference: opendrift/models/physics_methods.py:458-486, a per-cell
Python loop over eigenvalue solves); here the 2x2 symmetric eigenproblem
is solved in closed form over the whole grid at once.
"""

import numpy as np


def ftle(X, Y, delta, duration):
    """FTLE field from displacement fields X, Y (grid-shaped)."""
    dx = np.gradient(X)
    dy = np.gradient(Y)
    J00 = dx[0] / (2.0 * delta)
    J10 = dy[0] / (2.0 * delta)
    J01 = dx[1] / (2.0 * delta)
    J11 = dy[1] / (2.0 * delta)
    # Cauchy-Green tensor D = J^T J (symmetric 2x2 per cell)
    a = J00 * J00 + J10 * J10
    b = J00 * J01 + J10 * J11
    c = J01 * J01 + J11 * J11
    # largest eigenvalue of [[a, b], [b, c]]
    lam_max = 0.5 * (a + c) + np.sqrt(0.25 * (a - c) ** 2 + b * b)
    lam_max = np.maximum(lam_max, 1e-30)
    return np.log(np.sqrt(lam_max)) / abs(duration)
