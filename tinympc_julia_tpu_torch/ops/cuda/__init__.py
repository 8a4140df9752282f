"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package builds nothing: a kernel is compiled with nvcc the
first time a CUDA tensor reaches its wrapper."""
from .condensed_kernel import (  # noqa: F401
    FusedCarry,
    condensed_fused_cuda,
    condensed_fused_reference,
    make_condensed_fused_solver,
)
