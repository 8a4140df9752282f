"""tinympc_julia_tpu_torch — the PyTorch/CUDA port of tinympc_julia_tpu.

The port runs the batched MPC solver on one NVIDIA GPU: PyTorch for the
tensor code around the kernels, and hand-written CUDA kernels (built with
nvcc at first use) where the JAX package has Pallas kernels.  It imports
neither jax nor flax; its tests hold it against the JAX package, which stays
beside it as the reference.

Ported so far, by slice: the main path of a batched user (setup: problem,
Riccati cache, condensed maps; ``TinyMPCSolver.solve_batch`` on the
condensed and fused paths; the three-phase straggler pipeline, fp32 or
staged with reduced-precision phases as the JAX headline runs it, through
kernel K1 in ops/cuda/condensed_kernel.py); the constrained path: the
reference-ordered single-instance ``solve`` (ops/admm.py), the projections
(ops/projections.py), the linear, cone and equality setters, and K1's
halfspace and cone projections, with the rocket lander (models/rocket.py);
per-lane adaptive rho (ops/rho.py, the Taylor-expanded maps, kernel K2);
the grouped path: G distinct problems x L lanes (parallel/grouped.py,
parallel/batch.py, the group grid of both kernels and K1's
reduced-precision head); closed-loop serving: the three MPC loops
(parallel/mpc.py, the fused one chained through K1's carry) and the
per-stage fused solve, kernel K3 (ops/cuda/fused.py); the bucketed
exact-rebuild adaptive-rho pipeline (parallel/rebuild.py,
``TinyMPCSolver.solve_batch_rebuild_adaptive``) and the requantized adaptive
continuation (parallel/pipeline.py), both on K1's group grid; the
long-horizon recursions (ops/scans.py: chunked condensation and associative
scans, ``solve(chunked=...)``, ``method="chunked"``, ``horizon_parallel``);
the rest of the user surface: the Julia-style LQR and its rho sensitivities
(``solve_lqr``, ``compute_sensitivity_autograd``, ``compute_sensitivity_fd``
in ops/riccati.py), checkpoints in the JAX package's file format
(utils/checkpoint.py, ``TinyMPCSolver.save``/``load``), ``torch.export`` of
the single and batched solves (utils/export.py), ``torch.profiler`` traces
and solve statistics (utils/profiling.py), the embedded C++ emitter
(codegen/, ``TinyMPCSolver.codegen``) and the ctypes binding of the native
runtime (native.py).  K1 runs its product
as a lane-tile GEMM on the H100 (fp32 FMA in index order, bf16 tensor cores
for reduced iterations), and every fp32 path runs its matmuls in full fp32
(utils/precision.py), whatever the process-wide TF32 setting.
"""

from .types import (  # noqa: F401
    Cache,
    ConeSet,
    Problem,
    Settings,
    Solution,
    State,
    default_settings,
    init_state,
    expand_lanes,
    make_problem,
    settings_bake_key,
    stack_instances,
)
from .ops import admm, projections, riccati, scans  # noqa: F401
from .ops import rho as rho_adaptation  # noqa: F401
from .ops.admm import solve  # noqa: F401
from .ops.riccati import (  # noqa: F401
    compute_sensitivity_autograd,
    compute_sensitivity_fd,
    precompute_cache,
    solve_lqr,
)
from .api import BatchWarmCarry, TinyMPCSolver  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "BatchWarmCarry", "Cache", "ConeSet", "Problem", "Settings", "Solution",
    "State", "TinyMPCSolver", "compute_sensitivity_autograd",
    "compute_sensitivity_fd", "default_settings", "expand_lanes",
    "init_state", "make_problem", "precompute_cache", "settings_bake_key",
    "solve", "solve_lqr", "stack_instances",
]
