"""Batch-level layers of the port: the masked batched ADMM loop, straggler
compaction, the three-phase fused solve, the two-phase adaptive-rho solve
and its requantized form, the bucketed exact-rebuild pipeline, the grouped
(G problems x L lanes) solver, the closed-loop MPC loops, and the sharded
solve over the ranks of a mesh with its convergence vote."""
from . import (batch, grouped, mesh, mpc, pipeline, rebuild,  # noqa: F401
               sharded)
from .batch import (broadcast_state, set_x0_batch,  # noqa: F401
                    solve_batch, solve_vmap)
from .grouped import (GroupedBatchSolver, expand_lanes,  # noqa: F401
                      stack_instances)
from .mesh import batch_sharding, make_mesh, shard_state  # noqa: F401
from .mpc import run_mpc_loop  # noqa: F401
from .pipeline import (requantized_adaptive_solve,  # noqa: F401
                       requantized_buckets, three_phase_solve,
                       two_phase_adaptive_solve)
from .rebuild import (BucketedRebuildPipeline,  # noqa: F401
                      compact_members, default_bucket_rhos,
                      make_bucketed_rebuild, predict_rho_bucketed,
                      rebuild_bucket_caches)
from .sharded import map_shards, solve_sharded  # noqa: F401
