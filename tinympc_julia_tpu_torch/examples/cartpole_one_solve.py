#!/usr/bin/env python3
"""Cart-pole single solve (analog of the reference's
examples/cartpole_example_one_solve.jl)."""
from tinympc_julia_tpu_torch.models import cartpole


def main(device="cuda"):
    solver = cartpole.make_solver(max_iter=10, device=device)
    solver.set_x0([0.5, 0.0, 0.0, 0.0])
    solver.solve()
    solution = solver.get_solution()
    print(solution.controls)


if __name__ == "__main__":
    main()
