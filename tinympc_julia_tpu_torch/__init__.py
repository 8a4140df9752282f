"""tinympc_julia_tpu_torch — the PyTorch/CUDA port of tinympc_julia_tpu.

The port runs the batched MPC solver on one NVIDIA GPU: PyTorch for the
tensor code around the kernels, and hand-written CUDA kernels (built with
nvcc at first use) where the JAX package has Pallas kernels.  It imports
neither jax nor flax; its tests hold it against the JAX package, which stays
beside it as the reference.

This first slice covers the main path of a batched user: setup (problem,
Riccati cache, condensed maps), ``TinyMPCSolver.solve_batch`` on the
condensed and fused paths, and the three-phase straggler pipeline, all
through kernel K1 (ops/cuda/condensed_kernel.py).
"""

from .types import (  # noqa: F401
    Cache,
    ConeSet,
    Problem,
    Settings,
    default_settings,
    make_problem,
    settings_bake_key,
)
from .ops.riccati import precompute_cache  # noqa: F401
from .api import BatchWarmCarry, TinyMPCSolver  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "BatchWarmCarry", "Cache", "ConeSet", "Problem", "Settings",
    "TinyMPCSolver", "default_settings", "make_problem", "precompute_cache",
    "settings_bake_key",
]
