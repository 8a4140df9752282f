"""Batch-level layers of the port: the masked batched ADMM loop, straggler
compaction, the three-phase fused solve, the two-phase adaptive-rho solve
and its requantized form, the bucketed exact-rebuild pipeline, the grouped
(G problems x L lanes) solver and the closed-loop MPC loops."""
from . import batch, grouped, mpc, pipeline, rebuild  # noqa: F401
from .batch import (broadcast_state, set_x0_batch,  # noqa: F401
                    solve_batch, solve_vmap)
from .grouped import (GroupedBatchSolver, expand_lanes,  # noqa: F401
                      stack_instances)
from .mpc import run_mpc_loop  # noqa: F401
from .pipeline import (requantized_adaptive_solve,  # noqa: F401
                       requantized_buckets, three_phase_solve,
                       two_phase_adaptive_solve)
from .rebuild import (BucketedRebuildPipeline,  # noqa: F401
                      compact_members, default_bucket_rhos,
                      make_bucketed_rebuild, predict_rho_bucketed,
                      rebuild_bucket_caches)
