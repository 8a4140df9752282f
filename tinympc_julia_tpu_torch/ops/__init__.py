"""Compute ops of the port: Riccati cache, condensed maps, CUDA kernels."""
from . import condensed, riccati  # noqa: F401
