"""Rocket soft-landing plant with thrust-cone SOC constraints.

Parameters from the reference's examples/rocket_landing_constraints.jl:17-58
(20 Hz double-integrator with gravity as an affine term).
State (6): position (3), velocity (3).  Inputs (3): thrust vector.
"""
from __future__ import annotations

import numpy as np

NX, NU = 6, 3

A = np.array([
    [1.0, 0.0, 0.0, 0.05, 0.0, 0.0],
    [0.0, 1.0, 0.0, 0.0, 0.05, 0.0],
    [0.0, 0.0, 1.0, 0.0, 0.0, 0.05],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
])
B = np.array([
    [0.000125, 0.0, 0.0],
    [0.0, 0.000125, 0.0],
    [0.0, 0.0, 0.000125],
    [0.005, 0.0, 0.0],
    [0.0, 0.005, 0.0],
    [0.0, 0.0, 0.005],
])
F = np.array([0.0, 0.0, -0.0122625, 0.0, 0.0, -0.4905])  # gravity
Q_DIAG = np.full(6, 101.0)
R_DIAG = np.full(3, 2.0)
RHO = 1.0
HORIZON = 10

# Cone coefficients (rocket_landing_constraints.jl:52-58):
# state glide-slope cone ||x[0:2]|| <= 0.5 * x[2]; thrust cone
# ||u[0:2]|| <= 0.25 * u[2].
MU_STATE = 0.5
MU_INPUT = 0.25

X_INIT = np.array([4.0, 2.0, 20.0, -3.0, 2.0, -4.5])
X_GOAL = np.zeros(6)


def params():
    return dict(A=A.copy(), B=B.copy(), f=F.copy(), Q=np.diag(Q_DIAG),
                R=np.diag(R_DIAG), rho=RHO, nx=NX, nu=NU, N=HORIZON)


def bounds(N: int = HORIZON):
    """Box bounds from rocket_landing_constraints.jl:36-49."""
    x_min = np.full((NX, N), -1e17)
    x_max = np.full((NX, N), 1e17)
    x_min[0, :] = -5.0; x_max[0, :] = 5.0
    x_min[1, :] = -5.0; x_max[1, :] = 5.0
    x_min[2, :] = -0.5; x_max[2, :] = 100.0
    x_min[3, :] = -10.0; x_max[3, :] = 10.0
    x_min[4, :] = -10.0; x_max[4, :] = 10.0
    x_min[5, :] = -20.0; x_max[5, :] = 20.0
    u_min = np.full((NU, N - 1), -10.0)
    u_max = np.full((NU, N - 1), 105.0)
    return x_min, x_max, u_min, u_max


def make_solver(N: int = HORIZON, max_iter: int = 100, *, dtype=None,
                device, **kw):
    """Solver configured like the rocket example: box + SOC constraints,
    tolerances 2e-3/1e-3 (rocket_landing_constraints.jl:61-68), on
    ``device``."""
    from ..api import TinyMPCSolver
    kw.setdefault("abs_pri_tol", 2e-3)
    kw.setdefault("abs_dua_tol", 1e-3)
    s = TinyMPCSolver(dtype=dtype, device=device)
    s.setup(A, B, F, np.diag(Q_DIAG), np.diag(R_DIAG), RHO, NX, NU, N,
            max_iter=max_iter, **kw)
    s.set_bound_constraints(*bounds(N))
    s.set_cone_constraints([0], [3], [MU_INPUT], [0], [3], [MU_STATE])
    return s


def reference_trajectory(k: int, N: int = HORIZON, ntotal: int = 100):
    """Linearly interpolated moving reference
    (rocket_landing_constraints.jl:107-113)."""
    Xref = np.zeros((NX, N))
    Uref = np.zeros((NU, N - 1))
    for i in range(N):
        frac = (i + k) / (ntotal - 1)
        Xref[:, i] = X_INIT + (X_GOAL - X_INIT) * frac
    Uref[2, :] = 10.0
    return Xref, Uref


def simulate(x, u):
    return A @ np.asarray(x) + B @ np.asarray(u) + F
