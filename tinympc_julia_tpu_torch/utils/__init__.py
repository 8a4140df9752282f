"""Utilities of the port: ``convert`` (numpy fixtures to tensors and back),
``precision`` (the full-fp32 matmul pin), ``checkpoint`` (save and load a
solver in the JAX package's file format), ``export`` (``torch.export`` of a
solve) and ``profiling`` (traces, solve statistics, timers).  Each submodule
is imported on its first access as an attribute (PEP 562), not here: the
compute modules import ``precision``, and an eager import of the others
would cycle through ``convert``."""
import importlib

_SUBMODULES = ("checkpoint", "convert", "export", "precision", "profiling")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
