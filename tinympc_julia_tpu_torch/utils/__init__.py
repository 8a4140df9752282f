"""Utilities of the port."""
from . import convert  # noqa: F401
