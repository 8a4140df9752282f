"""The port's straggler compaction and its pipelines vs the JAX package: the
three-phase pipeline as bench.py builds it from JAX K1 factories (all phases
at HIGHEST precision) and the two-phase adaptive-rho pipeline as the grouped
solver builds it from the JAX adaptive kernel, both in interpret mode off
the TPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.ops.pallas.adaptive_kernel import (
    make_condensed_adaptive_fused_solver as jax_adaptive)
from tinympc_julia_tpu.ops.pallas.condensed_kernel import (
    make_condensed_fused_solver as jax_fused)
from tinympc_julia_tpu.parallel.rebuild import (
    compact_members as jax_compact)
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
    condensed_fused_reference)
from tinympc_julia_tpu_torch.ops.cuda.adaptive_kernel import (
    condensed_adaptive_reference)
from tinympc_julia_tpu_torch.parallel.pipeline import STAGED
from tinympc_julia_tpu_torch.parallel import (compact_members,
                                              three_phase_solve,
                                              two_phase_adaptive_solve)

from torch_port_common import (INTERPRET, cartpole_setup, taylor_setup,
                               x0_batch)


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


def _jax_pipeline(jp, jc, jm, x0s, slots, staged=False, head=0):
    """bench.py's _pipeline with every phase at HIGHEST (the port's
    all-fp32 form), or with ``staged`` its phase 0 at Precision.DEFAULT and
    a ``head``-iteration bf16 head in phase 2 (bench.py's staging).  Each
    phase runs as one tile: a lane's result does not depend on its tile."""
    m0, m1, m2 = BUDGETS
    kw = dict(en_input_bound=True, en_state_bound=False,
              relaxation_alpha=1.7, check_termination=4,
              interpret=INTERPRET)
    B = x0s.shape[0]
    fn0 = jax_fused(4, 1, 20, max_iter=m0, carry_out=True, batch_tile=B,
                    **dict(kw, check_termination=m0),
                    **(dict(precision=jax.lax.Precision.DEFAULT)
                       if staged else {}))
    fn1 = jax_fused(4, 1, 20, max_iter=m1, warm_start=True, carry_out=True,
                    batch_tile=B, **kw)
    fn2 = jax_fused(4, 1, 20, max_iter=m2, warm_start=True,
                    batch_tile=slots, bf16_head_iters=head, **kw)
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


# The staged pipeline's phase-2 head in the tests: a multiple of the check
# interval, kept short for the same compile-time reason as phase 0.
HEAD = 16


def test_staged_three_phase_control_flow_matches_jax(monkeypatch):
    """Rounding off (the JAX side is off the TPU, where DEFAULT precision
    computes in fp32): the staged pipeline (phase 0 at "default" with its
    one end check, a reduced head in phase 2) follows bench.py's staged
    ``_pipeline`` lane for lane in every phase."""
    monkeypatch.setattr(K, "bf16_round", lambda t: t)
    B, slots = 256, 128
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = x0_batch(B, 3).astype(np.float32)
    it1, ok1, idx, it2, ok2, unconv = _jax_pipeline(
        jp, jc, jm, jnp.asarray(x0), slots, staged=True, head=HEAD)
    res = three_phase_solve(pm, float(pc.rho), pp.u_min, pp.u_max, pp.x_min,
                            pp.x_max, torch.as_tensor(x0), nx=4, nu=1, N=20,
                            straggler_slots=slots, budgets=BUDGETS,
                            phase0_bf16=True, phase2_bf16_head=HEAD)
    n_strag = int(np.asarray(unconv).sum())
    assert 0 < n_strag <= slots
    np.testing.assert_array_equal(res.unconv.numpy(), np.asarray(unconv))
    np.testing.assert_array_equal(res.iters1.numpy(), np.asarray(it1))
    np.testing.assert_array_equal(res.solved1.numpy(), np.asarray(ok1))
    np.testing.assert_array_equal(res.idx.numpy(), np.asarray(idx))
    # phase 2: off the TPU the Pallas kernel's DEFAULT dot sums in another
    # order than its HIGHEST one, which may move a lane that sits on the
    # tolerance by one check interval (as in the head's kernel test)
    mask = np.arange(slots) < n_strag
    ip, ij = res.iters2.numpy()[mask], np.asarray(it2)[mask]
    same = ip == ij
    assert same.mean() >= 0.95 and (np.abs(ip - ij) <= 4).all()
    np.testing.assert_array_equal(res.solved2.numpy()[mask][same],
                                  np.asarray(ok2)[mask][same])
    assert int(res.iters2[res.valid].min()) >= HEAD  # the head ran


def test_staged_three_phase_keeps_quality():
    """Rounding on: against the fp32 pipeline on the same budgets the staged
    one (``STAGED``'s phase 0, a short head) converges as many lanes
    (within 1) and lands within 2e-2 on the lanes both solved; it is not the
    fp32 pipeline."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.as_tensor(x0_batch(256, 3), dtype=torch.float32)
    args = (pm, float(pc.rho), pp.u_min, pp.u_max, pp.x_min, pp.x_max, x0)
    kw = dict(nx=4, nu=1, N=20, straggler_slots=128, budgets=BUDGETS)
    assert STAGED["phase0_bf16"] and STAGED["phase2_bf16_head"] == 96
    staged = three_phase_solve(*args, phase0_bf16=True,
                               phase2_bf16_head=HEAD, **kw)
    plain = three_phase_solve(*args, **kw)
    assert int(staged.converged()) >= int(plain.converged()) - 1
    xs, us, _, ok = _merged(staged)
    xp, up, _, okp = _merged(plain)
    both = (ok == 1) & (okp == 1)
    assert int(both.sum()) > 200
    assert float((us - up)[both].abs().max()) < 2e-2
    assert not torch.equal(us, up)


def _merged(res):
    """(xs, us, final count, solved) per lane, phase-2 slots merged."""
    it, ok = res.iters1.clone(), res.solved1.clone()
    lanes = res.idx[res.valid]
    it[lanes] += res.iters2[res.valid]
    ok[lanes] = res.solved2[res.valid]
    return res.xs, res.us, it, ok


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


ADAPTIVE_BUDGETS = (30, 400)


def _jax_adaptive_pipeline(jp, jc, jt, x0s, slots):
    """The two-phase pipeline of the JAX grouped solver at one group, with
    the bench row's controller settings: bulk pass with the carry,
    compaction, warm continuation, merge."""
    m1, m2 = ADAPTIVE_BUDGETS
    plant = tuple(np.asarray(a) for a in (jp.A, jp.B, jp.Q, jp.R, jc.Pinf,
                                          jc.dPinf_drho))
    kw = dict(en_input_bound=True, en_state_bound=False,
              controller="termination", taylor_trust=2.0,
              adaptive_rho_min=float(jc.rho), adaptive_rho_max=1e3,
              interpret=INTERPRET)
    B = x0s.shape[0]
    fn1 = jax_adaptive(*plant, 20, batch_tile=B, max_iter=m1, carry_out=True,
                       **kw)
    fn2 = jax_adaptive(*plant, 20, batch_tile=slots, max_iter=m2,
                       warm_start=True, **kw)
    bounds = (jp.u_min, jp.u_max, jp.x_min, jp.x_max)
    xs1, us1, it1, ok1, rho1, carry = fn1(jt, *bounds, x0s)
    unconv = ok1 == 0
    idx = jnp.nonzero(unconv, size=slots, fill_value=0)[0]
    warm = type(carry)(*(w[:, idx] for w in carry))
    xs2, us2, it2, ok2, rho2 = fn2(jt, *bounds, x0s[idx], warm)
    n = int(unconv.sum())
    lanes = np.asarray(idx)[:min(n, slots)]
    out = [np.array(a) for a in (xs1, us1, it1, ok1, rho1)]
    for a, b in zip(out, (xs2, us2, m1 + it2, ok2, rho2)):
        a[lanes] = np.asarray(b)[:lanes.size]
    return out, np.asarray(unconv)


@pytest.mark.parametrize("slots,overflow", [(64, 0), (16, None)],
                         ids=["room", "overflow"])
def test_two_phase_adaptive_solve_matches_jax_pipeline(slots, overflow):
    """B = 128, f32, the bench row's controller (termination, trust 2, rho
    floored at rho0) on the cartpole from a mis-set-low rho0 = 0.3: the same
    stragglers, then on the merged lanes both solved equal counts on >= 95%,
    controls within 1e-4 and rho within rtol 5e-4 (a prediction is rho times
    the root of a ratio of residuals that are small near convergence, which
    magnifies the fp32 reassociation between the two matmul orders; one lane
    of 119 lands at 1.3e-4); stragglers beyond the slots keep their
    bulk-pass result and are counted."""
    B = 128
    (jp, jc, jt), (pp, pc, pt) = taylor_setup(dtype=jnp.float32, model=cartpole,
                                              rho=0.3, ub=5.0)
    x0 = x0_batch(B, 9).astype(np.float32)
    (jx, ju, jit, jok, jrho), unconv = _jax_adaptive_pipeline(
        jp, jc, jt, jnp.asarray(x0), slots)
    res = two_phase_adaptive_solve(
        pt, pp.u_min, pp.u_max, pp.x_min, pp.x_max, torch.as_tensor(x0),
        nx=4, nu=1, N=20, straggler_slots=slots, budgets=ADAPTIVE_BUDGETS)
    n_strag = int(unconv.sum())
    assert n_strag > 16
    np.testing.assert_array_equal(res.unconv.numpy(), unconv)
    assert int(res.overflow) == (max(n_strag - slots, 0) if overflow is None
                                 else overflow)
    assert (overflow is None) == (n_strag > slots)
    both = (res.solved.numpy() == 1) & (jok == 1)
    assert both.sum() > (0.9 * B if overflow == 0 else B - n_strag)
    same = res.iters.numpy()[both] == jit[both]
    assert same.mean() >= 0.95
    sel = np.flatnonzero(both)[same]
    np.testing.assert_allclose(res.rho.numpy()[sel], jrho[sel], rtol=5e-4)
    np.testing.assert_allclose(res.us.numpy()[sel], ju[sel], atol=1e-4,
                               rtol=1e-4)
    assert (res.rho.numpy() != 0.3).any()
    # a straggler's count includes the bulk pass
    cont = unconv & (res.solved.numpy() == 1)
    assert (res.iters.numpy()[cont] > ADAPTIVE_BUDGETS[0]).all()


def test_two_phase_adaptive_solve_with_the_plain_solver_is_the_same():
    """``fused=condensed_adaptive_reference`` (how measurements time the
    plain pipeline) gives the dispatching pipeline's result on CPU tensors;
    budgets off the rho-update grid are refused."""
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=jnp.float32, model=cartpole,
                                           rho=0.3, ub=5.0)
    x0 = torch.as_tensor(x0_batch(48, 10), dtype=torch.float32)
    args = (pt, pp.u_min, pp.u_max, pp.x_min, pp.x_max, x0)
    kw = dict(nx=4, nu=1, N=20, straggler_slots=16, budgets=(20, 100))
    a = two_phase_adaptive_solve(*args, **kw)
    b = two_phase_adaptive_solve(*args, fused=condensed_adaptive_reference,
                                 **kw)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="multiples of 5"):
        two_phase_adaptive_solve(*args, **dict(kw, budgets=(22, 100)))
