"""Benchmark plants (numpy-only copies of tinympc_julia_tpu/models)."""
from . import cartpole, quadrotor, rocket  # noqa: F401
