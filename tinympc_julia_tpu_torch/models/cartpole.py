"""Cart-pole plant — the reference's primary benchmark workload.

Parameters from the reference (tinympc-julia)
examples/cartpole_example_one_solve.jl:11-17
(shared by the MPC-loop, constrained, codegen and animation examples).
State: [cart position, cart velocity, pole angle, pole angular velocity].
"""
from __future__ import annotations

import numpy as np

NX, NU = 4, 1

A = np.array([
    [1.0, 0.01, 0.0, 0.0],
    [0.0, 1.0, 0.039, 0.0],
    [0.0, 0.0, 1.002, 0.01],
    [0.0, 0.0, 0.458, 1.002],
])
B = np.array([[0.0], [0.02], [0.0], [0.067]])
Q_DIAG = np.array([10.0, 1.0, 10.0, 1.0])
R_DIAG = np.array([1.0])
RHO = 1.0
HORIZON = 20


def params():
    return dict(A=A.copy(), B=B.copy(), Q=np.diag(Q_DIAG), R=np.diag(R_DIAG),
                rho=RHO, nx=NX, nu=NU, N=HORIZON)


def make_solver(N: int = HORIZON, max_iter: int = 100, *, constrained=False,
                dtype=None, device, **kw):
    """A ready TinyMPCSolver; `constrained=True` applies the reference's
    constrained-example bounds (cart pos +-2 m, force +-5 N,
    cartpole_example_reference_constrained.jl:16-18)."""
    from ..api import TinyMPCSolver
    s = TinyMPCSolver(dtype=dtype, device=device)
    s.setup(A, B, None, np.diag(Q_DIAG), np.diag(R_DIAG), RHO, NX, NU, N,
            max_iter=max_iter, **kw)
    if constrained:
        x_min = np.full((NX, N), -1e17)
        x_max = np.full((NX, N), 1e17)
        x_min[0, :] = -2.0
        x_max[0, :] = 2.0
        s.set_bound_constraints(x_min, x_max,
                                np.full((NU, N - 1), -5.0),
                                np.full((NU, N - 1), 5.0))
    return s


def simulate(x, u):
    """One plant step x' = A x + B u (the examples' closed-loop update,
    cartpole_example_mpc.jl:45)."""
    return A @ np.asarray(x) + B @ np.asarray(u)
