"""The port's straggler compaction and three-phase pipeline vs the JAX
package (the pipeline as bench.py builds it from JAX K1 factories, run in
interpret mode off the TPU, all phases at HIGHEST precision)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tinympc_julia_tpu.ops.pallas.condensed_kernel import (
    make_condensed_fused_solver as jax_fused)
from tinympc_julia_tpu.parallel.rebuild import (
    compact_members as jax_compact)
from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
    condensed_fused_reference)
from tinympc_julia_tpu_torch.parallel import compact_members, \
    three_phase_solve

from torch_port_common import INTERPRET, cartpole_setup, x0_batch


@pytest.mark.parametrize("G,M,slots,p", [
    (1, 64, 16, 0.2),    # room to spare
    (1, 64, 8, 0.5),     # overflow
    (3, 50, 10, 0.3),    # several groups, some overflowing
    (2, 40, 40, 1.0),    # every position a member, exactly full
    (2, 40, 5, 0.0),     # no members: all slots invalid, index-0 fill
])
def test_compact_members_matches_jax(G, M, slots, p):
    member = np.random.default_rng(G * 1000 + M).random((G, M)) < p
    j_idx, j_counts, j_valid, j_over = jax_compact(jnp.asarray(member),
                                                   slots)
    idx, counts, valid, over = compact_members(torch.as_tensor(member),
                                               slots)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(over.numpy(), np.asarray(j_over))
    assert over.dtype == torch.int32 and idx.dtype == torch.int64


# Phase budgets of the test: bench.py's 36/324 tail, with phase 0 cut from
# 56 to 24 iterations, because the Pallas kernel unrolls a cold phase's
# first check interval (here all of phase 0) and its interpret-mode compile
# time grows with it (about 19 s at 56 on this test's CPU).
BUDGETS = (24, 36, 324)


def _jax_pipeline(jp, jc, jm, x0s, slots):
    """bench.py's _pipeline with every phase at HIGHEST (the port's
    all-fp32 form).  Each phase runs as one tile: a lane's result does not
    depend on its tile."""
    m0, m1, m2 = BUDGETS
    kw = dict(en_input_bound=True, en_state_bound=False,
              relaxation_alpha=1.7, check_termination=4,
              interpret=INTERPRET)
    B = x0s.shape[0]
    fn0 = jax_fused(4, 1, 20, max_iter=m0, carry_out=True, batch_tile=B,
                    **dict(kw, check_termination=m0))
    fn1 = jax_fused(4, 1, 20, max_iter=m1, warm_start=True, carry_out=True,
                    batch_tile=B, **kw)
    fn2 = jax_fused(4, 1, 20, max_iter=m2, warm_start=True,
                    batch_tile=slots, **kw)
    bounds = (jp.u_min, jp.u_max, jp.x_min, jp.x_max)
    _, _, _, ok0, carry0 = fn0(jm, jc.rho, *bounds, x0s)
    _, _, it1, ok1p, carry = fn1(jm, jc.rho, *bounds, x0s, carry0)
    ok1 = jnp.maximum(ok0, ok1p)
    unconv = ok1 == 0
    idx = jnp.nonzero(unconv, size=slots, fill_value=0)[0]
    warm = tuple(w[:, idx] for w in carry)
    _, _, it2, ok2 = fn2(jm, jc.rho, *bounds, x0s[idx], warm)
    return it1, ok1, idx, it2, ok2, unconv


def test_three_phase_solve_matches_jax_pipeline():
    """B = 512, 128 straggler slots, f32: the same converged count and the
    same per-lane iteration counts in every phase."""
    B, slots = 512, 128
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = x0_batch(B, 0).astype(np.float32)
    it1, ok1, idx, it2, ok2, unconv = _jax_pipeline(jp, jc, jm,
                                                    jnp.asarray(x0), slots)
    res = three_phase_solve(pm, float(pc.rho), pp.u_min, pp.u_max, pp.x_min,
                            pp.x_max, torch.as_tensor(x0), nx=4, nu=1, N=20,
                            straggler_slots=slots, budgets=BUDGETS)
    n_strag = int(np.asarray(unconv).sum())
    assert 0 < n_strag <= slots
    np.testing.assert_array_equal(res.unconv.numpy(), np.asarray(unconv))
    np.testing.assert_array_equal(res.iters1.numpy(), np.asarray(it1))
    np.testing.assert_array_equal(res.solved1.numpy(), np.asarray(ok1))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(idx))
    mask = np.arange(slots) < n_strag
    np.testing.assert_array_equal(res.valid.numpy(), mask)
    np.testing.assert_array_equal(res.iters2.numpy()[mask],
                                  np.asarray(it2)[mask])
    n_jax = int(np.asarray(ok1).sum() + np.asarray(ok2)[mask].sum())
    assert int(res.converged()) == n_jax
    assert n_jax > 0.9 * B
    # merged solutions: stragglers carry their phase-2 result
    lanes = res.idx[res.valid]
    assert torch.isfinite(res.us).all()
    assert float(res.us.abs().max()) <= 5.0 + 1e-5
    assert lanes.numel() == n_strag


def test_three_phase_solve_with_the_plain_solver_is_the_same():
    """``fused=condensed_fused_reference`` (how measurements time the plain
    pipeline) gives the dispatching pipeline's result on CPU tensors."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.as_tensor(x0_batch(96, 5, scale=2.0), dtype=torch.float32)
    args = (pm, float(pc.rho), pp.u_min, pp.u_max, pp.x_min, pp.x_max, x0)
    a = three_phase_solve(*args, nx=4, nu=1, N=20, straggler_slots=32)
    b = three_phase_solve(*args, nx=4, nu=1, N=20, straggler_slots=32,
                          fused=condensed_fused_reference)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert int(a.total_iters(56)) > 56 * 96
