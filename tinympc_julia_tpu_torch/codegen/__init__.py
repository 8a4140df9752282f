"""Embedded code generation (counterpart of tinympc_julia_tpu/codegen): emit
a standalone, dependency-free C++ project with the solver's state baked in."""
from . import emitter  # noqa: F401
from .emitter import codegen  # noqa: F401
