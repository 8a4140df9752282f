#!/usr/bin/env python3
"""Rocket landing with box + second-order cone constraints and affine gravity
(analog of the reference's examples/rocket_landing_constraints.jl)."""
import numpy as np

from tinympc_julia_tpu_torch.models import rocket


def main(device="cuda"):
    solver = rocket.make_solver(device=device)
    ntotal = 100
    x = rocket.X_INIT * 1.1
    violations = 0
    for k in range(ntotal - rocket.HORIZON):
        Xref, Uref = rocket.reference_trajectory(k)
        tracking_error = np.linalg.norm(x - Xref[:, 1])
        if k % 10 == 0:
            print(f"step {k:3d}: tracking error {tracking_error:8.4f} "
                  f"alt {x[2]:7.3f}")
        solver.set_x0(x)
        solver.set_x_ref(Xref)
        solver.set_u_ref(Uref)
        solver.solve()
        u = solver.get_solution().controls[:, 0]
        x = rocket.simulate(x, u)
        if x[2] < 0 or np.linalg.norm(u[:2]) > 0.25 * abs(u[2]):
            violations += 1
    print(f"\nFinal position: {np.round(x[:3], 2)}")
    print(f"Final velocity: {np.round(x[3:], 2)}")
    print(f"Plant-level violations: {violations}/{ntotal - rocket.HORIZON} "
          "(solver-level cone/box constraints hold on every plan)")
    return x


if __name__ == "__main__":
    main()
