"""The port's bucketed exact-rebuild pipeline (parallel/rebuild.py), its API
method and the requantized adaptive continuation (parallel/pipeline.py)
against the JAX package: the bucket centres and caches, the per-lane rho
prediction from the same phase-1 carry, the whole pipeline against the JAX
one in interpret mode lane for lane, the lane mask, the two-launch staged
phase 2, the API (a ragged batch, the overflow warning, a bounds change
and a cone change between calls: no byte digest keys anything), the
quality against the port's own per-update rebuild, and the requantized
continuation against the JAX adaptive row's inline pipeline."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.ops.condensed import build_condensed as jax_build
from tinympc_julia_tpu.ops.pallas.adaptive_kernel import (
    make_condensed_adaptive_fused_solver as jax_adaptive)
from tinympc_julia_tpu.ops.pallas.condensed_kernel import (
    FusedCarry as JaxCarry, make_condensed_fused_solver as jax_fused,
    problem_constraint_kw as jax_constraint_kw)
from tinympc_julia_tpu.parallel import rebuild as JR
from tinympc_julia_tpu.parallel.grouped import stack_instances as jax_stack
from tinympc_julia_tpu_torch.ops.condensed import build_condensed
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.parallel import batch as PB
from tinympc_julia_tpu_torch.parallel import rebuild as RB
from tinympc_julia_tpu_torch.parallel.pipeline import (
    requantized_adaptive_solve, requantized_buckets)
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import (CART_X_BOUND, CPU, INTERPRET, cartpole_setup,
                               jax_arrays, port_copies, rocket_setup,
                               rocket_x0, taylor_setup, x0_batch)

RHO0 = 0.01
N = cartpole.HORIZON
F32 = torch.float32
# the mis-set cartpole's settings (tests/test_rebuild_pipeline.py): |u| <=
# 5, |x_0| <= 2, buckets over [1e-4, 1e4]
MISSET = dict(max_iter=500, en_state_bound=True, en_input_bound=True,
              adaptive_rho_min=1e-4, adaptive_rho_max=1e4)


def _misset(B, seed=5, dtype=jnp.float32):
    """The mis-set-rho0 constrained cartpole (JAX problem, cache), the
    port's copies and the x0s of tests/test_rebuild_pipeline.py."""
    (jp, jc, _), (pp, pc, _) = cartpole_setup(dtype, state_bound=True,
                                              rho=RHO0)
    rng = np.random.default_rng(seed)
    x0 = (rng.uniform(-1, 1, size=(B, 4))
          * np.array([1.8, 1.0, 0.4, 0.5])).astype(np.float32)
    return (jp, jc), (pp, pc), x0


def _jax_pipeline(jp, jc, x0, B, slots, ct=1, **kw):
    s = J.Settings(**dict(MISSET, check_termination=ct))
    pipe = JR.make_bucketed_rebuild(jp, jc, s, phase1_iters=50,
                                    straggler_slots=slots, batch_tile=8,
                                    interpret=INTERPRET, **kw)
    return pipe, [np.asarray(o) for o in pipe.solve(jnp.asarray(x0))]


def _port_pipeline(pp, pc, x0, slots, ct=1, **kw):
    s = P.Settings(**dict(MISSET, check_termination=ct))
    pipe = RB.make_bucketed_rebuild(pp, pc, s, phase1_iters=50,
                                    straggler_slots=slots, **kw)
    return pipe, [o.numpy() for o in pipe.solve(torch.as_tensor(x0))]


@pytest.mark.parametrize("lo,hi,per_decade", [
    (1e-4, 1e4, 0.5), (1e-3, 1e3, 0.5), (0.1, 10.0, 0.5), (0.05, 7.3, 0.5),
    (1e-4, 1e4, 1.0), (2.0, 3.0, 0.5)])
def test_default_bucket_rhos_equal_jax(lo, hi, per_decade):
    port = RB.default_bucket_rhos(lo, hi, per_decade)
    assert port == JR.default_bucket_rhos(lo, hi, per_decade)
    assert all(type(r) is float for r in port)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-10),
                                       (jnp.float32, 1e-5)],
                         ids=["float64", "float32"])
def test_rebuild_bucket_caches_match_jax_and_setup(dtype, tol):
    """Each bucket cache: the JAX package's, and the port's
    ``precompute_cache`` of the problem set up at the bucket rho."""
    (jp, jc), (pp, pc), _ = _misset(4, dtype=dtype)
    rhos = (1e-4, 0.1, 1.0, 10.0, 1e4)
    jb = JR.rebuild_bucket_caches(jp, jc, rhos)
    pb = RB.rebuild_bucket_caches(pp, pc, rhos)

    def close(a, b, what):
        """Within ``tol`` of the larger of 1 and the bucket's largest
        entry (Pinf reaches 2e3 at rho 1e4)."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.maximum(1.0, np.abs(b).reshape(len(rhos), -1).max(1))
        err = np.abs(a - b).reshape(len(rhos), -1).max(1) / scale
        assert (err <= tol).all(), (what, err)

    for field in ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "C1", "C2"):
        close(getattr(pb, field).numpy(), getattr(jb, field), field)
    for field in ("Kinf", "Pinf", "Quu_inv", "AmBKt"):
        want = []
        for r in rhos:
            r = torch.tensor(r, dtype=pp.dtype)
            want.append(getattr(P.precompute_cache(
                pp.A, pp.B, pp.Q - pp.rho_setup + r, pp.R - pp.rho_setup + r,
                r, compute_sensitivity=False), field).numpy())
        close(getattr(pb, field).numpy(), np.stack(want), field)


def _predict_case(case):
    """(JAX problem, cache, maps), the port's copies, Settings pair, x0s and
    buckets of a prediction case."""
    B = 64
    if case == "rocket-cones":
        (jp, jc, jm), (pp, pc, pm) = rocket_setup(jnp.float32)
        x0 = rocket_x0(B).astype(np.float32)
        kw = dict(abs_pri_tol=2e-3, en_state_bound=True, en_input_bound=True,
                  en_input_soc=True, en_state_soc=True,
                  adaptive_rho_min=1e-3, adaptive_rho_max=1e3)
    else:
        bounded = case == "cartpole-state-bound"
        (jp, jc, jm), (pp, pc, pm) = cartpole_setup(
            jnp.float32, state_bound=bounded, rho=RHO0)
        x0 = (np.random.default_rng(5).uniform(-1, 1, size=(B, 4))
              * np.array([1.8, 1.0, 0.4, 0.5])).astype(np.float32)
        kw = dict(MISSET, en_state_bound=bounded, relaxation_alpha=1.3)
    return (jp, jc, jm), (pp, pc, pm), (J.Settings(**kw), P.Settings(**kw)), x0


@pytest.mark.parametrize("case", ["cartpole-box", "cartpole-state-bound",
                                  "rocket-cones"])
def test_predict_rho_bucketed_matches_jax(case):
    """The same phase-1 carry (the JAX kernel's, in interpret mode): rho
    within rtol 1e-5 and equal buckets, except on lanes whose two nearest
    log-distances are within 1e-5 of each other."""
    (jp, jc, jm), (pp, pc, pm), (js, ps), x0 = _predict_case(case)
    fn = jax_fused(jp.nx, jp.nu, jp.N, batch_tile=x0.shape[0], max_iter=50,
                   carry_out=True, abs_pri_tol=js.abs_pri_tol,
                   abs_dua_tol=js.abs_dua_tol,
                   en_state_bound=js.en_state_bound,
                   en_input_bound=js.en_input_bound,
                   relaxation_alpha=js.relaxation_alpha, interpret=INTERPRET,
                   **jax_constraint_kw(jp, js))
    *_, carry = fn(jm, jc.rho, jp.u_min, jp.u_max, jp.x_min, jp.x_max,
                   jnp.asarray(x0))
    rhos = JR.default_bucket_rhos(js.adaptive_rho_min, js.adaptive_rho_max)
    jb, jr = JR.predict_rho_bucketed(jp, js, jm, carry, jnp.asarray(x0),
                                     jc.rho.astype(jnp.float32), rhos)
    pcarry = convert.carry_from_numpy(jax_arrays(carry), dtype=F32,
                                      device=CPU)
    pb, pr = RB.predict_rho_bucketed(pp, ps, pm, pcarry, torch.as_tensor(x0),
                                     float(pc.rho), rhos)
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=1e-5)
    dist = np.sort(np.abs(np.log(pr.numpy().astype(np.float64))[:, None]
                          - np.log(rhos)[None, :]), axis=1)
    differ = pb.numpy() != np.asarray(jb)
    assert (dist[differ, 1] - dist[differ, 0] < 1e-5).all()
    assert differ.mean() < 0.05
    if case != "rocket-cones":  # the mis-set lanes spread over buckets
        assert len(set(pb.tolist())) >= 2


def _phase1_view(iters, solved, phase1=50):
    """What phase 1 decided per lane: its count where it converged the lane
    (``phase1 + 1`` marks a straggler)."""
    return np.where((iters <= phase1) & (solved == 1), iters, phase1 + 1)


def test_bucketed_rebuild_matches_jax():
    """B = 64, 64 slots a bucket: the same phase-1 counts and stragglers on
    every lane; on lanes both solved with equal counts (>= 95% of lanes)
    controls within 1e-4 and equal rho; equal overflow."""
    B = 64
    (jp, jc), (pp, pc), x0 = _misset(B)
    jpipe, j = _jax_pipeline(jp, jc, x0, B, B, phase2_iters=450)
    ppipe, p = _port_pipeline(pp, pc, x0, B, phase2_iters=450)
    assert ppipe.bucket_rhos == jpipe.bucket_rhos
    np.testing.assert_array_equal(_phase1_view(p[2], p[3]),
                                  _phase1_view(j[2], j[3]))
    both = (p[3] == 1) & (j[3] == 1) & (p[2] == j[2])
    assert both.mean() >= 0.95
    np.testing.assert_allclose(p[1][both], j[1][both], atol=1e-4)
    np.testing.assert_array_equal(p[4][both], j[4][both])
    np.testing.assert_array_equal(p[5], j[5])
    assert (p[4] > RHO0).sum() >= B // 4  # stragglers moved to a bucket


def test_overflow_matches_jax():
    """B = 32 with 8 slots a bucket: the same per-bucket overflow; the
    overflowed lanes keep phase 1's unconverged result at rho0."""
    B = 32
    (jp, jc), (pp, pc), x0 = _misset(B, seed=7)
    _, j = _jax_pipeline(jp, jc, x0, B, 8, phase2_iters=200)
    _, p = _port_pipeline(pp, pc, x0, 8, phase2_iters=200)
    assert p[5].sum() > 0
    np.testing.assert_array_equal(p[5], j[5])
    np.testing.assert_array_equal(_phase1_view(p[2], p[3]),
                                  _phase1_view(j[2], j[3]))
    overflowed = (p[2] == 50) & (p[3] == 0)
    assert overflowed.sum() == p[5].sum()
    np.testing.assert_array_equal(p[4][overflowed], np.float32(RHO0))
    same = p[2] == j[2]
    assert same.mean() >= 0.95
    np.testing.assert_array_equal(p[3][same], j[3][same])


def test_lane_mask_keeps_pad_lanes_out_of_phase_2():
    """Lanes outside the mask never take a phase-2 slot (phase-1 state,
    rho0), and the real lanes equal a solve of those lanes alone."""
    B = 16
    (_, _), (pp, pc), x0 = _misset(B, seed=9)
    pipe = RB.make_bucketed_rebuild(pp, pc, P.Settings(**MISSET),
                                    phase1_iters=50, straggler_slots=8,
                                    phase2_iters=200)
    x = torch.as_tensor(x0)
    out = pipe.solve(x, torch.arange(B) < 8)
    alone = pipe.solve(x[:8])
    assert (out[2][8:] <= 50).all()
    assert torch.equal(out[4][8:], torch.full((8,), RHO0, dtype=F32))
    assert (out[4][:8] != RHO0).any()
    for a, b in zip(out[:5], alone[:5]):
        assert torch.equal(a[:8], b)


def test_staged_phase_2_is_two_launches(monkeypatch):
    """``phase2_bf16_iters``: at ct = 1 every iteration checks, so the
    staged pipeline (phase 1 and a 40-iteration phase-2 head at "default")
    is the fp32 one lane for lane; at ct = 5, rounding off, it follows the
    JAX staged pipeline (interpret mode: its DEFAULT dot computes in fp32)
    on >= 95% of lanes."""
    B = 32
    (jp, jc), (pp, pc), x0 = _misset(B, seed=13)
    _, plain = _port_pipeline(pp, pc, x0, B, phase2_iters=200)
    _, staged = _port_pipeline(pp, pc, x0, B, phase2_iters=160,
                               phase1_bf16=True, phase2_bf16_iters=40)
    for a, b in zip(plain, staged):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(K, "bf16_round", lambda t: t)
    kw = dict(phase2_iters=160, phase1_bf16=True, phase2_bf16_iters=40)
    _, j = _jax_pipeline(jp, jc, x0, B, B, ct=5, **kw)
    _, p = _port_pipeline(pp, pc, x0, B, ct=5, **kw)
    same = p[2] == j[2]
    assert same.mean() >= 0.95
    both = same & (p[3] == 1) & (j[3] == 1)
    assert both.sum() >= 0.9 * B
    np.testing.assert_allclose(p[1][both], j[1][both], atol=1e-4)
    # lanes latched inside the head keep its result: counts 51..90
    assert ((p[2] > 50) & (p[2] <= 90)).any()
    with pytest.raises(ValueError, match="multiple of"):
        _port_pipeline(pp, pc, x0, B, ct=5, phase2_iters=160,
                       phase2_bf16_iters=42)


def _api_solver(ub=5.0, max_iter=500):
    s = P.TinyMPCSolver(dtype=F32, device=CPU)
    s.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
            np.diag(cartpole.R_DIAG), RHO0, 4, 1, N, max_iter=max_iter,
            adaptive_rho_min=1e-4, adaptive_rho_max=1e4)
    s.set_bound_constraints(np.tile(-CART_X_BOUND[:, None], (1, N)),
                            np.tile(CART_X_BOUND[:, None], (1, N)),
                            np.full((1, N - 1), -ub), np.full((1, N - 1), ub))
    return s


def test_api_ragged_batch_and_overflow_warning():
    """B = 24 (no tile multiple): tensors on the solver's device, the
    pipeline's own results, ``last_overflow``; too few slots warn."""
    B = 24
    x0 = _misset(B, seed=11)[2]
    s = _api_solver()
    xs, us, iters, solved, rho = s.solve_batch_rebuild_adaptive(
        x0, phase1_iters=50, phase2_iters=450)
    assert xs.shape == (B, N, 4) and us.shape == (B, N - 1, 1)
    assert all(isinstance(t, torch.Tensor) for t in (xs, us, iters, rho))
    assert int(solved.sum()) >= 0.9 * B
    assert float(rho.max()) > RHO0
    assert s.last_overflow is not None and int(s.last_overflow.sum()) == 0
    pipe = RB.make_bucketed_rebuild(s.problem, s.cache, s.settings,
                                    phase1_iters=50, straggler_slots=B,
                                    phase2_iters=450)
    for a, b in zip((xs, us, iters, solved, rho),
                    pipe.solve(torch.as_tensor(x0))):
        assert torch.equal(a, b)
    with pytest.warns(UserWarning, match="straggler_slots too small"):
        s.solve_batch_rebuild_adaptive(x0, straggler_slots=2,
                                       phase1_iters=50, phase2_iters=450)
    assert int(s.last_overflow.sum()) > 0
    assert s.last_overflow.shape == (5,)
    f64 = P.TinyMPCSolver(dtype=torch.float64, device=CPU)
    f64.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
              np.diag(cartpole.R_DIAG), RHO0, 4, 1, N)
    with pytest.raises(TypeError, match="float32"):
        f64.solve_batch_rebuild_adaptive(x0)


def test_bounds_change_between_calls_is_respected():
    """The counterpart of test_setter_changes_invalidate_cached_pipeline:
    the bounds reach the kernels at every call."""
    s = _api_solver(max_iter=300)
    x0 = (np.random.default_rng(5).uniform(-1, 1, size=(16, 4))
          * np.array([1.8, 1.0, 0.4, 0.5]))
    _, us1, _, _, _ = s.solve_batch_rebuild_adaptive(
        x0, phase1_iters=20, phase2_iters=100)
    s.set_bound_constraints(np.tile(-CART_X_BOUND[:, None], (1, N)),
                            np.tile(CART_X_BOUND[:, None], (1, N)),
                            np.full((1, N - 1), -2.0),
                            np.full((1, N - 1), 2.0))
    _, us2, _, _, _ = s.solve_batch_rebuild_adaptive(
        x0, phase1_iters=20, phase2_iters=100)
    assert float(us1.abs().max()) > 2.0 + 1e-6  # the old bound was active
    assert float(us2.abs().max()) <= 2.0 + 1e-5


def test_cone_structure_change_is_respected():
    """A state cone moved from (start 0, dim 2) to (start 2, dim 2) with the
    same coefficient bytes: the second call projects onto the new cone
    (the JAX API's cache key hashes the coefficients' bytes only, and
    would reuse the old pipeline)."""
    s = _api_solver(max_iter=300)
    x0 = (np.random.default_rng(5).uniform(-1, 1, size=(16, 4))
          * np.array([1.8, 1.0, 0.4, 0.5]))

    def violation(xs, start):
        return float((xs[..., start].abs()
                      - 0.5 * xs[..., start + 1]).max())

    s.set_cone_constraints([], [], [], [0], [2], [0.5])
    xs1 = s.solve_batch_rebuild_adaptive(x0, phase1_iters=20,
                                         phase2_iters=100)[0]
    s.set_cone_constraints([], [], [], [2], [2], [0.5])
    xs2 = s.solve_batch_rebuild_adaptive(x0, phase1_iters=20,
                                         phase2_iters=100)[0]
    assert violation(xs1, 0) <= 1e-5 and violation(xs1, 2) > 1e-3
    assert violation(xs2, 2) <= 1e-5 and violation(xs2, 0) > 1e-3


def test_rescues_misset_rho_with_standard_quality():
    """Against the port's own per-update rebuild (``adaptive_rho_rebuild``
    on the standard path) on 16 lanes: the fixed-rho0 control fails many
    lanes, the pipeline converges as many as the standard rebuild (or 95%)
    in fewer iterations than the control, and its controls are as close to
    a 1e-6 oracle (the condensed solve of the same QP at rho 1) as the
    standard rebuild's."""
    B = 16
    (_, _), (pp, pc), x0 = _misset(B)
    x = torch.as_tensor(x0)
    st = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(4, 1, N, dtype=F32, device=CPU), B), x)
    _, _, fix = PB.solve_batch(pp, pc, P.Settings(max_iter=500), st)
    _, _, reb = PB.solve_batch(pp, pc, P.Settings(
        max_iter=500, adaptive_rho=True, adaptive_rho_controller="termination",
        adaptive_rho_rebuild=True, adaptive_rho_min=1e-4,
        adaptive_rho_max=1e4), st)
    pipe = RB.make_bucketed_rebuild(pp, pc, P.Settings(**MISSET),
                                    phase1_iters=50, straggler_slots=B,
                                    phase2_iters=450)
    _, us, iters, solved, rho, overflow = pipe.solve(x)
    # the oracle: the same QP (user costs and bounds) set up at rho 1
    po = P.make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                        np.diag(cartpole.R_DIAG), 1.0, N, u_min=-5.0,
                        u_max=5.0, x_min=np.tile(-CART_X_BOUND, (N, 1)),
                        x_max=np.tile(CART_X_BOUND, (N, 1)),
                        dtype=torch.float64, device=CPU)
    co = P.precompute_cache(po.A, po.B, po.Q, po.R, po.rho_setup)
    from tinympc_julia_tpu_torch.ops.condensed import solve_condensed
    _, u_star, _, ok_t = solve_condensed(
        po, co, P.Settings(max_iter=20000, abs_pri_tol=1e-6,
                           abs_dua_tol=1e-6), x.double(),
        build_condensed(po, co))
    n_fix, n_reb = int(fix.solved.sum()), int(reb.solved.sum())
    assert n_fix < 0.75 * B
    assert int(solved.sum()) >= min(n_reb, int(0.95 * B))
    ok = solved == 1
    assert float(iters[ok].float().mean()) < \
        0.6 * float(fix.iter.float().mean())
    assert float(rho.max()) >= 1.0 and not overflow.any()
    mask = (ok_t == 1) & ok & (reb.solved == 1)
    assert int(mask.sum()) >= B // 2
    e_bkt = (us.double() - u_star).abs().amax(dim=(1, 2))[mask].numpy()
    e_reb = (reb.u.double() - u_star).abs().amax(dim=(1, 2))[mask].numpy()
    assert np.median(e_bkt) <= 2 * max(np.median(e_reb), 1e-4)
    assert np.quantile(e_bkt, 0.9) <= 2 * max(np.quantile(e_reb, 0.9), 1e-3)


REQ_BUDGETS = (30, 400)


def _jax_requantized(jp, jc, jt, x0s, slots, head):
    """bench.py's quadrotor_adaptive inline pipeline on the cartpole's
    Taylor maps: the adaptive bulk pass with its carry, each straggler's
    rho snapped onto exact caches at rho0 + {0, 1, 2} (linear distance),
    zero-filled pad slots, the adaptive carry converted, the grouped fixed
    kernel warm with a reduced head; results merged per lane."""
    m1, m2 = REQ_BUDGETS
    plant = tuple(np.asarray(a) for a in (jp.A, jp.B, jp.Q, jp.R, jc.Pinf,
                                          jc.dPinf_drho))
    B = x0s.shape[0]
    fn1 = jax_adaptive(*plant, jp.N, batch_tile=B, max_iter=m1,
                       carry_out=True, en_input_bound=True,
                       en_state_bound=False, controller="termination",
                       taylor_trust=2.0, adaptive_rho_min=float(jc.rho),
                       adaptive_rho_max=1e3, interpret=INTERPRET)
    buckets = tuple(float(jc.rho) + d for d in (0.0, 1.0, 2.0))
    G = len(buckets)
    bcaches = JR.rebuild_bucket_caches(jp, jc, buckets)
    bmaps = jax_build(jax_stack([jp] * G), bcaches)
    brho = jnp.asarray(buckets, jnp.float32)
    fn2 = jax_fused(jp.nx, jp.nu, jp.N, batch_tile=slots, max_iter=m2,
                    warm_start=True, num_groups=G, bf16_head_iters=head,
                    en_input_bound=True, en_state_bound=False,
                    interpret=INTERPRET)
    bounds = (jp.u_min, jp.u_max, jp.x_min, jp.x_max)
    xs1, us1, it1, ok1, rho1, carry = fn1(jt, *bounds, x0s)
    unconv = ok1 == 0
    bucket = jnp.argmin(jnp.abs(carry.rho[0][:, None] - brho[None, :]),
                        axis=1)
    m = unconv[None, :] & (bucket[None, :] == jnp.arange(G)[:, None])
    idx, _, valid, overflow = JR.compact_members(m, slots)
    gidx = idx.reshape(-1)
    w2 = jnp.concatenate([carry.z - carry.y, carry.v - carry.g], axis=0)

    def gather(a):
        return jnp.where(valid[None, :], a[:, gidx], 0.0)

    warm = JaxCarry(gather(w2), gather(carry.y), gather(carry.g),
                    gather(carry.v), gather(carry.z))
    x0s2 = jnp.where(valid[:, None], x0s[gidx], 0.0)
    xs2, us2, it2, ok2 = fn2(bmaps, brho, *bounds, x0s2, warm)
    out = [np.array(a) for a in (xs1, us1, it1, ok1, rho1)]
    lanes = np.asarray(gidx)[np.asarray(valid)]
    for a, b in zip(out, (xs2, us2, m1 + it2, ok2,
                          jnp.repeat(brho, slots))):
        a[lanes] = np.asarray(b)[np.asarray(valid)]
    return out, np.asarray(unconv), np.asarray(overflow)


@pytest.mark.parametrize("slots,head", [(64, 0), (16, 16)],
                         ids=["room-fp32", "overflow-head"])
def test_requantized_adaptive_solve_matches_jax_pipeline(monkeypatch, slots,
                                                         head):
    """B = 128 from rho0 = 0.3 (the cartpole's Taylor maps), at the bars of
    test_two_phase_adaptive_solve_matches_jax_pipeline: the same stragglers
    and overflow; on the lanes both solved, equal counts on >= 95%, and
    there controls within 1e-4 and rho within rtol 5e-4.  The head runs
    with rounding off (the JAX side is off the TPU)."""
    monkeypatch.setattr(K, "bf16_round", lambda t: t)
    B = 128
    (jp, jc, jt), (pp, pc, pt) = taylor_setup(cartpole, jnp.float32,
                                              rho=0.3, ub=5.0)
    x0 = x0_batch(B, 9).astype(np.float32)
    (jx, ju, jit, jok, jrho), unconv, jover = _jax_requantized(
        jp, jc, jt, jnp.asarray(x0), slots, head)
    rhos, bmaps = requantized_buckets(pp, pc)
    assert rhos == pytest.approx((0.3, 1.3, 2.3))
    res = requantized_adaptive_solve(
        pt, bmaps, rhos, pp.u_min, pp.u_max, pp.x_min, pp.x_max,
        torch.as_tensor(x0), nx=4, nu=1, N=N, straggler_slots=slots,
        budgets=REQ_BUDGETS, bf16_head_iters=head)
    n_strag = int(unconv.sum())
    assert n_strag > 16
    np.testing.assert_array_equal(res.unconv.numpy(), unconv)
    np.testing.assert_array_equal(res.overflow.numpy(), jover)
    assert (int(res.overflow.sum()) > 0) == (slots == 16)
    both = (res.solved.numpy() == 1) & (jok == 1)
    assert both.sum() > (0.9 * B if slots == 64 else B - n_strag)
    same = res.iters.numpy()[both] == jit[both]
    assert same.mean() >= 0.95
    sel = np.flatnonzero(both)[same]
    np.testing.assert_allclose(res.rho.numpy()[sel], jrho[sel], rtol=5e-4)
    np.testing.assert_allclose(res.us.numpy()[sel], ju[sel], atol=1e-4,
                               rtol=1e-4)
    cont = unconv & (res.solved.numpy() == 1)
    assert (res.iters.numpy()[cont] > REQ_BUDGETS[0]).all()
    assert np.isclose(res.rho.numpy()[cont][:, None],
                      np.array([0.3, 1.3, 2.3], np.float32)).any(1).all()
