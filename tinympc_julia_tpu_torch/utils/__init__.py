"""Utilities of the port: ``convert`` (numpy fixtures to tensors and back),
``precision`` (the full-fp32 matmul pin), ``checkpoint`` (save and load a
solver in the JAX package's file format), ``export`` (``torch.export`` of a
solve) and ``profiling`` (traces, solve statistics, timers).  Submodules are
imported where they are used, so the compute modules can import
``precision`` without a cycle through ``convert``."""
