"""Benchmark plants (numpy-only copies of tinympc_julia_tpu/models)."""
from . import cartpole, quadrotor  # noqa: F401
