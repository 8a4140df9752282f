#!/usr/bin/env python3
"""Quadrotor hover with sensitivity-enabled code generation (analog of the
reference's examples/quadrotor_hover_codegen.jl).  Sensitivities here are
exact forward-mode derivatives, not finite differences."""
import sys

import numpy as np

from tinympc_julia_tpu_torch.models import quadrotor

ENABLE_ADAPTIVE_RHO = True


def main(out_dir="out/quadrotor_codegen", device="cuda"):
    solver = quadrotor.make_solver(adaptive_rho=ENABLE_ADAPTIVE_RHO,
                                   adaptive_rho_min=0.1, adaptive_rho_max=10.0,
                                   device=device)
    solver.set_x_ref(np.zeros((12, 20)))
    solver.set_u_ref(np.zeros((4, 19)))

    if ENABLE_ADAPTIVE_RHO:
        print("Adaptive rho enabled - generating code with sensitivity "
              "matrices (exact forward-mode AD)...")
        dK, dP, dC1, dC2 = solver.compute_sensitivity_autograd()
        solver.codegen_with_sensitivity(out_dir, dK, dP, dC1, dC2,
                                        verbose=True)
    else:
        solver.codegen(out_dir, verbose=True)
    print(f"Code generation completed successfully in: {out_dir}")


if __name__ == "__main__":
    main(*sys.argv[1:])
