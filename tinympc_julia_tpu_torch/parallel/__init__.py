"""Batch-level pipelines of the port: straggler compaction and the
three-phase fused solve."""
from . import pipeline, rebuild  # noqa: F401
from .pipeline import three_phase_solve  # noqa: F401
from .rebuild import compact_members  # noqa: F401
