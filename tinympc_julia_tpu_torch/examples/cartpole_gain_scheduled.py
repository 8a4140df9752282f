#!/usr/bin/env python3
"""Cart-pole swing-up-style loop with adaptive cost re-setup every 10 steps
(analog of the reference's examples/cartpole_interactive_animation.jl:60-77,
which re-calls `setup` with re-tuned Q mid-loop; plotting optional)."""
import numpy as np

from tinympc_julia_tpu_torch import TinyMPCSolver
from tinympc_julia_tpu_torch.models import cartpole


def tuned_Q(x):
    """Crude gain schedule: weight the pole angle more when it is large."""
    angle = abs(float(x[2]))
    w = 10.0 + 90.0 * min(angle / 0.5, 1.0)
    return np.diag([10.0, 1.0, w, 1.0])


def main(nsteps=120, plot=False, device="cuda"):
    solver = TinyMPCSolver(device=device)
    x = np.array([0.0, 0.0, 0.35, 0.0])
    traj = []
    for t in range(nsteps):
        if t % 10 == 0:  # re-setup with re-tuned cost, like the reference
            solver.setup(cartpole.A, cartpole.B, None, tuned_Q(x),
                         np.diag(cartpole.R_DIAG), cartpole.RHO, 4, 1,
                         cartpole.HORIZON, max_iter=100)
        solver.set_x0(x)
        solver.solve()
        u = solver.get_solution().controls[:, 0]
        x = cartpole.simulate(x, u)
        traj.append(x.copy())
    traj = np.array(traj)
    print(f"final state norm: {np.linalg.norm(x):.3e}")
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.plot(traj[:, 0], label="cart position")
        plt.plot(traj[:, 2], label="pole angle")
        plt.legend()
        plt.savefig("cartpole_gain_scheduled.png", dpi=120)
        print("saved cartpole_gain_scheduled.png")
    return traj


if __name__ == "__main__":
    main()
