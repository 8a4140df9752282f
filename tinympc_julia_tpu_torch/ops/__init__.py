"""Compute ops of the port: Riccati cache, condensed maps, the single-instance
ADMM and its projections, adaptive rho, the horizon scans, CUDA kernels.
``condensed`` and ``riccati`` are imported here, the other submodules on
their first access as an attribute (PEP 562), as in ``utils``: importing
the maps does not load the solvers and the kernels' wrappers."""
import importlib

from . import condensed, riccati  # noqa: F401

_SUBMODULES = ("admm", "cuda", "projections", "rho", "scans")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
