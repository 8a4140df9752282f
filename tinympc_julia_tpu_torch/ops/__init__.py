"""Compute ops of the port: Riccati cache, condensed maps, the single-instance
ADMM and its projections, CUDA kernels."""

from . import condensed, riccati  # noqa: F401
