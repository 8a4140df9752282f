"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version:
K1 (fixed-rho condensed ADMM, condensed_kernel.py), K2 (per-lane adaptive
rho, adaptive_kernel.py) and K3 (per-stage ADMM, fused.py).

Importing this package builds nothing: a kernel is compiled with nvcc the
first time a CUDA tensor reaches its wrapper."""
from .condensed_kernel import (  # noqa: F401
    FusedCarry,
    condensed_fused_cuda,
    condensed_fused_reference,
    make_condensed_fused_solver,
)
from .adaptive_kernel import (  # noqa: F401
    AdaptiveFusedCarry,
    condensed_adaptive_cuda,
    condensed_adaptive_reference,
    make_condensed_adaptive_fused_solver,
)
from .fused import (  # noqa: F401
    fused_cuda,
    fused_reference,
    make_fused_solver,
)
