"""Utilities of the port: ``convert`` (numpy fixtures to tensors and back)
and ``precision`` (the full-fp32 matmul pin).  Submodules are imported where
they are used, so the compute modules can import ``precision`` without a
cycle through ``convert``."""
