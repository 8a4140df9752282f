#!/usr/bin/env python3
"""Cart-pole swing-up with animation, the analog of the reference's
examples/cartpole_interactive_animation.jl:140-269.

The reference swings the pole up from hanging (theta = pi) to upright with a
three-regime adaptive cost (aggressive swing / intermediate / stabilize,
`:60-77`), re-calling `setup` every 10 steps, trying 5 perturbed starts
sequentially and keeping the best, then renders a GIF.

Here:
- "Re-setup with new Q" is not a solver rebuild: the three cost regimes are
  three precomputed (Problem, Cache) pairs stacked on a regime axis, and
  each step selects one per lane (an index into the stack).
- The reference's 5 sequential attempts run as ONE batch: each closed-loop
  step solves all perturbed starts at once (``parallel.solve_batch`` with
  per-lane problems and caches), and each lane picks its own cost regime
  from its own angle error.
- Visualization: matplotlib GIF (cart + pole + trace) plus an .npz dump of
  the trajectories.  Run with --no-gif for the npz only.
"""
import sys

import numpy as np
import torch

from tinympc_julia_tpu_torch import (Settings, init_state, make_problem,
                                     precompute_cache, stack_instances)
from tinympc_julia_tpu_torch.parallel import (broadcast_state, set_x0_batch,
                                              solve_batch)
from tinympc_julia_tpu_torch.types import map_tensors

# Reference plant: strong gravity + high control authority
# (cartpole_interactive_animation.jl:20-25)
A = np.array([[1.0, 0.01, 0.0, 0.0],
              [0.0, 1.0, 0.065, 0.0],
              [0.0, 0.0, 1.003, 0.01],
              [0.0, 0.0, 0.850, 1.003]])
B = np.array([[0.0], [0.045], [0.0], [0.120]])
R = np.diag([0.6])                          # :28
N = 20
RHO = 1.0
ATTEMPTS = 5                                # :48
MAX_STEPS = 500                             # :17
STABLE_STEPS = 40                           # :56

# Adaptive cost regimes (:62-70): aggressive swing, intermediate, stabilize
REGIME_Q = [np.diag([3.0, 0.8, 0.5, 0.8]),       # angle error >= 1.0
            np.diag([10.0, 2.0, 30.0, 15.0]),    # 0.5 <= angle error < 1.0
            np.diag([15.0, 3.0, 300.0, 30.0])]   # angle error < 0.5


def build_regimes(device, dtype=torch.float32):
    """One (Problem, Cache) pair per cost regime, stacked on a leading
    regime axis so a lane's regime choice is an index."""
    probs, caches = [], []
    for Q in REGIME_Q:
        p = make_problem(A, B, Q, R, RHO, N, dtype=dtype, device=device)
        probs.append(p)
        caches.append(precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup))
    return stack_instances(probs), stack_instances(caches)


def swingup_batch(device, dtype=torch.float32):
    """All reference attempts as one batched closed loop; returns
    (states (ATTEMPTS, MAX_STEPS, 4), controls (ATTEMPTS, MAX_STEPS),
    stable_at (ATTEMPTS,) first step index with STABLE_STEPS of stability)."""
    regimes_p, regimes_c = build_regimes(device, dtype)
    s = Settings(max_iter=100, en_state_bound=False, en_input_bound=False)
    At = torch.as_tensor(A, dtype=dtype, device=device)
    Bt = torch.as_tensor(B, dtype=dtype, device=device)

    # perturbed hanging starts (:49-51)
    var = 0.02 * np.arange(ATTEMPTS)
    x0 = np.stack([var, np.zeros(ATTEMPTS), np.pi + 0.1 * var,
                   np.zeros(ATTEMPTS)], axis=1)
    x = torch.as_tensor(x0, dtype=dtype, device=device)
    st = set_x0_batch(broadcast_state(
        init_state(4, 1, N, dtype=dtype, device=device), ATTEMPTS), x)
    stable = torch.zeros(ATTEMPTS, dtype=torch.int32, device=device)

    xs, us, stables = [], [], []
    for _ in range(MAX_STEPS):
        angle_err = x[:, 2].abs()
        r = (angle_err < 1.0).long() + (angle_err < 0.5).long()
        prob = map_tensors(lambda a: a[r], regimes_p)
        cache = map_tensors(lambda a: a[r], regimes_c)
        st = set_x0_batch(st, x)
        st, _, sol = solve_batch(prob, cache, s, st, problem_batched=True,
                                 cache_batched=True)
        u = sol.u[:, 0, 0]
        x = x @ At.T + u[:, None] * Bt[:, 0]
        # wrap angle to [-pi, pi] (:92)
        x[:, 2] = torch.remainder(x[:, 2] + np.pi, 2 * np.pi) - np.pi
        ok = ((x[:, 2].abs() < 0.1) & (x[:, 3].abs() < 0.05)
              & (x[:, 1].abs() < 0.05))                   # :96
        stable = torch.where(ok, stable + 1, 0)
        xs.append(x)
        us.append(u)
        stables.append(stable)
    xs = torch.stack(xs, 1).cpu().numpy()
    us = torch.stack(us, 1).cpu().numpy()
    reached = torch.stack(stables, 1).cpu().numpy() >= STABLE_STEPS
    stable_at = np.where(reached.any(axis=1), reached.argmax(axis=1),
                         MAX_STEPS)
    return xs, us, stable_at


def render_gif(states, controls, path="cartpole_swingup.gif", fps=25,
               stride=2):
    """Cart + pole + trace animation (create_animation analog, :140-269)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    pole_len = 1.2                                          # :147
    pos, ang = states[:, 0], states[:, 2]
    frames = range(0, len(states), stride)

    fig, (ax, axu) = plt.subplots(
        2, 1, figsize=(7, 6), height_ratios=[3, 1], constrained_layout=True)
    ax.set_xlim(pos.min() - 1.5, pos.max() + 1.5)
    ax.set_ylim(-1.5, 1.6)
    ax.set_aspect("equal")
    ax.axhline(0, color="0.6", lw=1)
    cart, = ax.plot([], [], "s", ms=18, color="tab:blue")
    pole, = ax.plot([], [], "-", lw=3, color="tab:red")
    tip, = ax.plot([], [], "o", ms=6, color="tab:red")
    trace, = ax.plot([], [], "-", lw=0.5, alpha=0.4, color="tab:red")
    title = ax.set_title("")
    axu.plot(controls, lw=1)
    axu.set_ylabel("u")
    axu.set_xlabel("step")
    marker = axu.axvline(0, color="k", lw=1)

    tips_x = pos + pole_len * np.sin(ang)
    tips_y = pole_len * np.cos(ang)

    def draw(k):
        cart.set_data([pos[k]], [0.0])
        pole.set_data([pos[k], tips_x[k]], [0.0, tips_y[k]])
        tip.set_data([tips_x[k]], [tips_y[k]])
        trace.set_data(tips_x[:k + 1], tips_y[:k + 1])
        marker.set_xdata([k])
        title.set_text(f"cart-pole swing-up  step {k}  "
                       f"angle {np.degrees(ang[k]):+.0f} deg")
        return cart, pole, tip, trace, marker

    ani = animation.FuncAnimation(fig, draw, frames=frames, blit=False)
    ani.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return path


def main(device="cuda"):
    make_gif = "--no-gif" not in sys.argv
    xs, us, stable_at = swingup_batch(torch.device(device))
    best = int(np.argmin(stable_at))
    if stable_at[best] >= MAX_STEPS:
        print("no attempt stabilized; dumping trajectories anyway")
    else:
        print(f"best attempt {best}: stabilized upright after "
              f"{stable_at[best]} steps ({stable_at[best] * 0.04:.1f} s); "
              f"per-attempt: {list(stable_at)}")
    end = int(min(stable_at[best] + STABLE_STEPS, MAX_STEPS))
    np.savez("cartpole_swingup.npz", states=xs, controls=us,
             stable_at=stable_at, best=best)
    print("saved cartpole_swingup.npz")
    if make_gif:
        path = render_gif(xs[best, :end], us[best, :end])
        print(f"saved {path}")


if __name__ == "__main__":
    main()
