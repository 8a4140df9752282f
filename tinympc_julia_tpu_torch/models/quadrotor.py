"""Quadrotor hover plant (Crazyflie-class, 20 Hz discretization).

Parameters from the reference (tinympc-julia)
examples/quadrotor_hover_codegen.jl:26-58.
State (12): position (3), attitude (3), linear velocity (3), angular rates (3).
Inputs (4): rotor thrust deviations from hover.
"""
from __future__ import annotations

import numpy as np

NX, NU = 12, 4

A = np.array([
    [1.0, 0.0, 0.0, 0.0, 0.024525, 0.0, 0.05, 0.0, 0.0, 0.0, 0.0002044, 0.0],
    [0.0, 1.0, 0.0, -0.024525, 0.0, 0.0, 0.0, 0.05, 0.0, -0.0002044, 0.0, 0.0],
    [0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.05, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.025, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.025, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.025],
    [0.0, 0.0, 0.0, 0.0, 0.981, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0122625, 0.0],
    [0.0, 0.0, 0.0, -0.981, 0.0, 0.0, 0.0, 1.0, 0.0, -0.0122625, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
])
B = np.array([
    [-0.0007069, 0.0007773, 0.0007091, -0.0007795],
    [0.0007034, 0.0007747, -0.0007042, -0.0007739],
    [0.0052554, 0.0052554, 0.0052554, 0.0052554],
    [-0.1720966, -0.1895213, 0.1722891, 0.1893288],
    [-0.1729419, 0.190174, 0.1734809, -0.1907131],
    [0.0123423, -0.0045148, -0.0174024, 0.0095748],
    [-0.056552, 0.0621869, 0.0567283, -0.0623632],
    [0.0562756, 0.0619735, -0.0563386, -0.0619105],
    [0.2102143, 0.2102143, 0.2102143, 0.2102143],
    [-13.7677303, -15.1617018, 13.7831318, 15.1463003],
    [-13.8353509, 15.2139209, 13.8784751, -15.2570451],
    [0.9873856, -0.361182, -1.392188, 0.7659845],
])
Q_DIAG = np.array([100.0, 100.0, 100.0, 4.0, 4.0, 400.0,
                   4.0, 4.0, 4.0, 2.0408163, 2.0408163, 4.0])
R_DIAG = np.array([4.0, 4.0, 4.0, 4.0])
RHO = 5.0
HORIZON = 20
U_HOVER_BOUND = 0.5


def params():
    return dict(A=A.copy(), B=B.copy(), Q=np.diag(Q_DIAG), R=np.diag(R_DIAG),
                rho=RHO, nx=NX, nu=NU, N=HORIZON)


def make_solver(N: int = HORIZON, max_iter: int = 500, *, input_bounds=True,
                dtype=None, device, **kw):
    from ..api import TinyMPCSolver
    s = TinyMPCSolver(dtype=dtype, device=device)
    s.setup(A, B, None, np.diag(Q_DIAG), np.diag(R_DIAG), RHO, NX, NU, N,
            max_iter=max_iter, **kw)
    if input_bounds:
        s.set_bound_constraints(
            np.full((NX, N), -1e17), np.full((NX, N), 1e17),
            np.full((NU, N - 1), -U_HOVER_BOUND),
            np.full((NU, N - 1), U_HOVER_BOUND))
        s.update_settings(en_state_bound=False)
    return s


def simulate(x, u):
    return A @ np.asarray(x) + B @ np.asarray(u)
