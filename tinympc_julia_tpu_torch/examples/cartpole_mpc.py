#!/usr/bin/env python3
"""Closed-loop cart-pole MPC, re-planning each step with warm starts
(analog of the reference's examples/cartpole_example_mpc.jl)."""
import numpy as np

from tinympc_julia_tpu_torch.models import cartpole


def main(nsteps=200, device="cuda"):
    solver = cartpole.make_solver(max_iter=100, device=device)
    x = np.array([0.5, 0.0, 0.0, 0.0])
    for t in range(nsteps):
        solver.set_x0(x)
        solver.solve()
        u = solver.get_solution().controls[:, 0]
        x = cartpole.simulate(x, u)
        if t % 20 == 0:
            print(f"step {t:3d}: x = {np.round(x, 4)} "
                  f"iters = {int(solver.solution.iter)}")
    print(f"final state norm: {np.linalg.norm(x):.2e} (stabilized)")
    return x


if __name__ == "__main__":
    main()
