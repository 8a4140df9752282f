"""Batch-level pipelines of the port: straggler compaction, the three-phase
fused solve and the two-phase adaptive-rho solve."""
from . import pipeline, rebuild  # noqa: F401
from .pipeline import (three_phase_solve,  # noqa: F401
                       two_phase_adaptive_solve)
from .rebuild import compact_members  # noqa: F401
