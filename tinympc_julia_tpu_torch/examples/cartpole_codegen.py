#!/usr/bin/env python3
"""Generate a standalone embedded C++ project for the cart-pole with input
bounds +-0.5 (analog of the reference's
examples/cartpole_example_code_generation.jl)."""
import sys

import numpy as np

from tinympc_julia_tpu_torch.models import cartpole


def main(out_dir="out/cartpole_codegen", device="cuda"):
    solver = cartpole.make_solver(max_iter=100, device=device)
    N = cartpole.HORIZON
    solver.set_bound_constraints(
        np.full((4, N), -1e17), np.full((4, N), 1e17),
        np.full((1, N - 1), -0.5), np.full((1, N - 1), 0.5))
    solver.set_x0([0.3, 0.0, 0.05, 0.0])
    solver.codegen(out_dir, verbose=True)
    print(f"build with: cmake -S {out_dir} -B {out_dir}/build && "
          f"cmake --build {out_dir}/build")


if __name__ == "__main__":
    main(*sys.argv[1:])
