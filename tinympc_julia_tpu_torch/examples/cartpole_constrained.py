#!/usr/bin/env python3
"""Closed-loop cart-pole with box constraints (cart pos +-2 m, force +-5 N),
analog of the reference's
examples/cartpole_example_reference_constrained.jl."""
import numpy as np

from tinympc_julia_tpu_torch.models import cartpole


def main(nsteps=150, device="cuda"):
    solver = cartpole.make_solver(max_iter=200, constrained=True,
                                  device=device)
    x = np.array([0.0, 0.0, 0.1, 0.0])
    max_u = 0.0
    max_pos = 0.0
    for t in range(nsteps):
        solver.set_x0(x)
        solver.solve()
        u = solver.get_solution().controls[:, 0]
        max_u = max(max_u, abs(float(u[0])))
        x = cartpole.simulate(x, u)
        max_pos = max(max_pos, abs(float(x[0])))
    print(f"max |force| = {max_u:.3f} (limit 5), "
          f"max |pos| = {max_pos:.3f} (limit 2)")
    print(f"final state norm: {np.linalg.norm(x):.2e}")
    return max_u, max_pos


if __name__ == "__main__":
    main()
