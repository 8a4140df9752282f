"""The grouped slice as a whole: the port's ``GroupedBatchSolver`` (G
distinct problems x L lanes) against the JAX package's, method by method.

The standard and condensed methods are held in float64: iterates within
1e-9, iteration counts equal on every lane.  The fused method is float32
(the JAX side runs its Pallas kernels in interpret mode off the TPU, the
port its kernels' plain versions on the CPU): iterates within 1e-5 (1e-4
with cones, the repo's rocket bar), iteration counts equal on every lane.
"""
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.parallel.grouped import (
    GroupedBatchSolver as JaxGrouped)
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.parallel import grouped as PG
from tinympc_julia_tpu_torch.parallel.grouped import GroupedBatchSolver

from torch_port_common import (grouped_cartpoles, grouped_rockets, jax_stack,
                               port_copies, rocket_x0, settings_pair)

F32, F64 = jnp.float32, jnp.float64
N = 8
ATOL32 = 1e-5


def _x0(G, L, seed, scale=0.5, nx=4):
    return np.random.default_rng(seed).uniform(-scale, scale, size=(G, L, nx))


def _pair(groups, **settings):
    (jps, jcs), (pps, pcs) = groups
    js, ps = settings_pair(**settings)
    return JaxGrouped(jps, jcs, js), GroupedBatchSolver(pps, pcs, ps)


def _same(j, p, atol):
    np.testing.assert_array_equal(p[2].numpy(), j[2])
    np.testing.assert_array_equal(p[3].numpy(), j[3])
    np.testing.assert_allclose(p[1].numpy(), j[1], atol=atol, rtol=0)
    np.testing.assert_allclose(p[0].numpy(), j[0], atol=atol, rtol=0)


@pytest.mark.parametrize("method", ["standard", "condensed", "auto"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_float64_methods_match_jax(method, adaptive):
    G, L = 3, 6
    jg, pg = _pair(grouped_cartpoles(G, F64, N=N), max_iter=100,
                   en_state_bound=False, adaptive_rho=adaptive,
                   adaptive_rho_min=0.3, adaptive_rho_max=8.0)
    x0 = _x0(G, L, 71)
    p = pg.solve_batch(x0, method=method)
    _same(jg.solve_batch(x0, method=method), p, 1e-9)
    assert p[0].shape == (G, L, N, 4) and p[2].shape == (G, L)
    assert int(p[3].sum()) > 0 and p[1].dtype == torch.float64


def test_condensed_matches_standard_within_the_port():
    """Fixed rho: the grouped condensed maps and the masked batched loop
    with per-lane problems give the same counts on every lane."""
    G, L = 3, 6
    _, pg = _pair(grouped_cartpoles(G, F64, N=N), max_iter=100,
                  en_state_bound=False)
    x0 = _x0(G, L, 73)
    c = pg.solve_batch(x0, method="condensed")
    s = pg.solve_batch(x0, method="standard")
    assert torch.equal(c[2], s[2]) and torch.equal(c[3], s[3])
    torch.testing.assert_close(c[1], s[1], atol=1e-9, rtol=0)


@pytest.mark.parametrize("name,settings,state_bound", [
    ("ct1", dict(max_iter=80, en_state_bound=False), False),
    ("relaxed-ct4", dict(max_iter=80, en_state_bound=False,
                         relaxation_alpha=1.7, check_termination=4), False),
    ("per-group-state-bounds", dict(max_iter=80, en_state_bound=True), True),
])
def test_fused_matches_jax(name, settings, state_bound):
    """Randomised cartpole groups with their own maps, rho and bounds."""
    G, L = 3, 16
    groups = grouped_cartpoles(G, F32, N=N, state_bound=state_bound)
    jg, pg = _pair(groups, **settings)
    x0 = _x0(G, L, 79).astype(np.float32)
    p = pg.solve_batch(x0, method="fused")
    _same(jg.solve_batch(x0, method="fused"), p, ATOL32)
    assert int(p[3].sum()) > G * L // 2
    ub = groups[1][0].u_max[:, 0, 0]
    assert float(ub.max() - ub.min()) > 0.5  # the bounds really differ
    for g in range(G):
        assert float(p[1][g].abs().max()) <= float(ub[g]) + 1e-5
    c = pg.solve_batch(x0, method="condensed")
    same = c[2] == p[2]
    assert float(same.float().mean()) >= 0.95
    torch.testing.assert_close(c[1][same], p[1][same], atol=2e-4, rtol=0)


def test_fused_per_group_cone_data_matches_jax():
    """The rocket sweep's shape: per-group thrust and glide-slope cone
    coefficients, the box given as scalars."""
    G, L = 2, 16
    groups = grouped_rockets(G, F32)
    jg, pg = _pair(groups, max_iter=100, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
                   en_state_bound=True, en_input_bound=True,
                   en_input_soc=True, en_state_soc=True)
    x0 = rocket_x0(G * L, seed=6).reshape(G, L, 6).astype(np.float32)
    j = jg.solve_batch(x0, method="fused")
    p = pg.solve_batch(x0, method="fused")
    _same(j, p, 1e-4)
    assert int(p[3].sum()) == G * L
    mus = groups[1][0].cones_u.mus[:, 0]
    for g in range(G):
        u = p[1][g]
        assert bool((torch.linalg.vector_norm(u[..., :2], dim=-1)
                     <= mus[g] * u[..., 2] + 5e-3).all())


def test_fused_per_group_halfspace_rows_match_jax():
    G, L = 2, 8
    probs, caches = [], []
    for g in range(G):
        p = J.make_problem(
            jnp.asarray(cartpole.A, F32), jnp.asarray(cartpole.B, F32),
            jnp.asarray(np.diag(cartpole.Q_DIAG), F32),
            jnp.asarray(np.diag(cartpole.R_DIAG), F32), 1.0, N, u_min=-5.0,
            u_max=5.0, Alin_u=jnp.asarray([[1.0]], F32),
            blin_u=jnp.asarray([1.0 + 1.5 * g], F32))
        probs.append(p)
        caches.append(J.precompute_cache(p.A, p.B, p.Q, p.R,
                                         jnp.asarray(1.0, F32)))
    jps, jcs = jax_stack(probs), jax_stack(caches)
    jg, pg = _pair(((jps, jcs), port_copies(jps, jcs, F32)), max_iter=80,
                   en_input_linear=True, en_state_bound=False)
    x0 = _x0(G, L, 83, scale=0.6).astype(np.float32)
    p = pg.solve_batch(x0, method="fused")
    _same(jg.solve_batch(x0, method="fused"), p, 1e-4)
    assert float(p[1][0].max()) <= 1.0 + 1e-4
    assert 1.0 + 1e-2 < float(p[1][1].max()) <= 2.5 + 1e-4


@pytest.mark.parametrize("controller", ["osqp", "termination"])
def test_adaptive_fused_matches_jax_and_condensed(controller):
    G, L = 3, 8
    kw = dict(max_iter=100, en_state_bound=False, adaptive_rho=True,
              adaptive_rho_min=0.3, adaptive_rho_max=8.0,
              adaptive_rho_controller=controller,
              adaptive_rho_taylor_trust=0.5)
    jg, pg = _pair(grouped_cartpoles(G, F32, N=N), **kw)
    x0 = _x0(G, L, 89).astype(np.float32)
    p = pg.solve_batch(x0, method="fused")
    j = jg.solve_batch(x0, method="fused")
    same = p[2].numpy() == j[2]
    assert same.mean() >= 0.95 and (np.abs(p[2].numpy() - j[2]) <= 1).all()
    np.testing.assert_allclose(p[1].numpy()[same], j[1][same], atol=1e-4)
    c = pg.solve_batch(x0, method="condensed")
    csame = c[2] == p[2]
    assert float(csame.float().mean()) >= 0.95
    torch.testing.assert_close(c[1][csame], p[1][csame], atol=5e-4, rtol=0)
    assert int(p[3].sum()) > 0


def test_single_group_fused():
    jg, pg = _pair(grouped_cartpoles(1, F32, N=N), max_iter=80,
                   en_state_bound=False)
    x0 = _x0(1, 16, 97).astype(np.float32)
    p = pg.solve_batch(x0, method="fused")
    _same(jg.solve_batch(x0, method="fused"), p, ATOL32)
    assert int(p[3].sum()) > 8


def test_fused_bf16_head_setting():
    """``Settings.bf16_head_iters`` on the plain fused method: counts are
    cumulative (never below the head), quality holds against the unstaged
    solve, and the short-tail warning fires only with cones or
    halfspaces."""
    G, L = 2, 16
    groups = grouped_cartpoles(G, F32, N=N)
    _, pg = _pair(groups, max_iter=80, en_state_bound=False,
                  check_termination=4, bf16_head_iters=8)
    _, pg0 = _pair(groups, max_iter=80, en_state_bound=False,
                   check_termination=4)
    x0 = _x0(G, L, 101).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p = pg.solve_batch(x0, method="fused")
    q = pg0.solve_batch(x0, method="fused")
    assert int(p[2].min()) >= 8 and int(p[3].sum()) >= int(q[3].sum()) - 1
    both = (p[3] == 1) & (q[3] == 1)
    assert float((p[1] - q[1])[both].abs().max()) < 2e-2
    assert not torch.equal(p[1], q[1])
    _, pr = _pair(grouped_rockets(2, F32), max_iter=40, abs_pri_tol=2e-3,
                  en_input_soc=True, en_state_soc=True, bf16_head_iters=8)
    with pytest.warns(UserWarning, match="full-precision iterations"):
        pr.solve_batch(rocket_x0(8, seed=6).reshape(2, 4, 6).astype(
            np.float32), method="fused")


# -- the two-phase pipeline ----------------------------------------------------

PIPE = dict(max_iter=20, en_state_bound=False)


def test_two_phase_pipeline_equals_one_long_solve_and_jax():
    """An exact continuation: per-lane results equal one fused solve of
    phase1 + phase2 iterations bit for bit (per-group compaction keeps every
    lane with its group's maps), and the JAX pipeline's within 1e-5."""
    G, L = 3, 16
    groups = grouped_cartpoles(G, F32, N=N)
    jg, pg = _pair(groups, **PIPE)
    _, plong = _pair(groups, **dict(PIPE, max_iter=80))
    x0 = _x0(G, L, 151, scale=0.7).astype(np.float32)
    one = plong.solve_batch(x0, method="fused")
    two = pg.solve_batch(x0, method="fused", pipeline=(20, 16, 60))
    assert bool((one[2] > 20).any())  # phase 1 leaves stragglers
    assert pg.last_overflow.tolist() == [0] * G
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    _same(jg.solve_batch(x0, method="fused", pipeline=(20, 16, 60)), two,
          ATOL32)


def test_pipeline_takes_lane_counts_off_any_tile():
    """L = 12 is no multiple of a tile on either side: the JAX package pads
    it, the port's kernels mask a ragged tile; the same lanes come back."""
    G, L = 2, 12
    groups = grouped_cartpoles(G, F32, N=N)
    jg, pg = _pair(groups, **PIPE)
    _, plong = _pair(groups, **dict(PIPE, max_iter=80))
    x0 = _x0(G, L, 107, scale=0.8).astype(np.float32)
    two = pg.solve_batch(x0, method="fused", pipeline=(20, 16, 60))
    assert two[0].shape == (G, L, N, 4)
    for a, b in zip(plong.solve_batch(x0, method="fused"), two):
        assert torch.equal(a, b)
    _same(jg.solve_batch(x0, method="fused", pipeline=(20, 16, 60)), two,
          ATOL32)


def test_valid_lanes_keeps_pad_lanes_out_of_phase_two():
    G, L, Lv = 2, 16, 10
    _, pg = _pair(grouped_cartpoles(G, F32, N=N), **PIPE)
    x0 = _x0(G, L, 109, scale=0.8).astype(np.float32)
    x0[:, Lv:] = 0.9  # hard pad lanes that would take every slot
    fn = pg.make_fused_pipeline(phase1_iters=20, straggler_slots=4,
                                phase2_iters=60, lanes=L, valid_lanes=Lv)
    xs, us, iters, solved, overflow = fn(torch.as_tensor(x0))
    assert int(iters[:, Lv:].max()) == 20  # pad lanes never continued
    ref = pg.make_fused_pipeline(phase1_iters=20, straggler_slots=4,
                                 phase2_iters=60, lanes=Lv)(
        torch.as_tensor(x0[:, :Lv]))
    for a, b in zip((xs, us, iters, solved), ref):
        assert torch.equal(a[:, :Lv], b)
    assert torch.equal(overflow, ref[4])


def test_straggler_overflow_keeps_phase1_state():
    G, L = 2, 16
    jg, pg = _pair(grouped_cartpoles(G, F32, N=N, seed=11), **PIPE)
    x0 = _x0(G, L, 113, scale=0.9).astype(np.float32)
    s1 = pg.solve_batch(x0, method="fused")
    stragglers = (s1[3] == 0).sum(dim=1)
    assert int(stragglers.min()) > 3  # 3 slots overflow in every group
    with pytest.warns(UserWarning, match="straggler_slots=3 too small"):
        p = pg.solve_batch(x0, method="fused", pipeline=(20, 3, 60))
    from_phase1 = (p[2] == s1[2]) & (p[3] == s1[3])
    continued = p[2] > 20
    assert bool((from_phase1 | continued).all())
    assert bool((p[3] >= s1[3]).all())
    kept = from_phase1 & (s1[3] == 0)
    assert torch.equal(p[1][kept], s1[1][kept])
    np.testing.assert_array_equal(pg.last_overflow,
                                  np.maximum(stragglers.numpy() - 3, 0))
    with pytest.warns(UserWarning, match="too small"):
        j = jg.solve_batch(x0, method="fused", pipeline=(20, 3, 60))
    _same(j, p, ATOL32)
    np.testing.assert_array_equal(pg.last_overflow, jg.last_overflow)


def test_adaptive_pipeline_matches_jax():
    """The grouped adaptive two-phase pipeline (the continuation restarts
    the rho-update counter, so it is held against the same two calls)."""
    G, L = 2, 8
    kw = dict(max_iter=20, en_state_bound=False, adaptive_rho=True,
              adaptive_rho_min=0.3, adaptive_rho_max=8.0)
    jg, pg = _pair(grouped_cartpoles(G, F32, N=N), **kw)
    x0 = _x0(G, L, 127, scale=0.8).astype(np.float32)
    p = pg.solve_batch(x0, method="fused", pipeline=(20, 16, 60))
    j = jg.solve_batch(x0, method="fused", pipeline=(20, 16, 60))
    same = p[2].numpy() == j[2]
    assert same.mean() >= 0.9 and bool((p[2] > 20).any())
    np.testing.assert_allclose(p[1].numpy()[same], j[1][same], atol=1e-4)
    np.testing.assert_array_equal(p[3].numpy()[same], j[3][same])


STAGED = dict(phase0_bf16_iters=16, phase1_iters=8, straggler_slots=16,
              phase2_iters=60, phase2_bf16_head=8)


def test_staged_pipeline_control_flow_matches_jax(monkeypatch):
    """Rounding off (as the JAX side is off the TPU): the three launches'
    merge (phase-0 lanes keep their result, the others' counts add k0, phase
    2 adds k0 + phase1_iters) is the JAX pipeline's lane for lane."""
    monkeypatch.setattr(K, "bf16_round", lambda t: t)
    G, L = 2, 16
    settings = dict(max_iter=20, en_state_bound=False, check_termination=4,
                    relaxation_alpha=1.7)
    jg, pg = _pair(grouped_cartpoles(G, F32, N=N), **settings)
    x0 = _x0(G, L, 131, scale=0.8).astype(np.float32)
    x0[:, :4] *= 1e-4  # lanes that latch inside phase 0
    p = pg.solve_batch(x0, method="fused", pipeline=dict(STAGED))
    j = jg.solve_batch(x0, method="fused", pipeline=dict(STAGED))
    _same(j, p, ATOL32)
    assert int(p[2].min()) < 16 < 24 < int(p[2].max())  # all three phases


def test_staged_pipeline_keeps_quality():
    """Rounding on: against the unstaged pipeline with the same budgets the
    staged one converges as many lanes (within 1) and lands within 2e-2 on
    the lanes both solved; every lane it reports solved was latched by a
    full-precision check."""
    G, L = 2, 16
    settings = dict(max_iter=20, en_state_bound=False, check_termination=4,
                    relaxation_alpha=1.7)
    _, pg = _pair(grouped_cartpoles(G, F32, N=N), **settings)
    x0 = _x0(G, L, 131, scale=0.8).astype(np.float32)
    staged = pg.solve_batch(x0, method="fused", pipeline=dict(STAGED))
    plain = pg.solve_batch(x0, method="fused", pipeline=(24, 16, 60))
    assert int(staged[3].sum()) >= int(plain[3].sum()) - 1
    both = (staged[3] == 1) & (plain[3] == 1)
    assert float((staged[1] - plain[1])[both].abs().max()) < 2e-2
    assert not torch.equal(staged[1], plain[1])


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_pipeline_takes_another_solver(adaptive):
    """``fused=`` puts a function of the plain version's signature in the
    place of every phase's solver: with the plain version itself the
    pipeline is the one the CPU runs anyway, and every launch goes through
    the function given."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    G, L = 2, 16
    settings = dict(PIPE, max_iter=20, adaptive_rho=adaptive,
                    adaptive_rho_min=0.3, adaptive_rho_max=8.0)
    _, pg = _pair(grouped_cartpoles(G, F32, N=N), **settings)
    x0 = torch.as_tensor(_x0(G, L, 151, scale=0.8).astype(np.float32))
    plain = (K2.condensed_adaptive_reference if adaptive
             else K.condensed_fused_reference)
    calls = []

    def counted(*args, **kw):
        calls.append(kw["max_iter"])
        return plain(*args, **kw)

    kw = dict(phase1_iters=20, straggler_slots=8, phase2_iters=60, lanes=L)
    if not adaptive:
        kw.update(phase0_bf16_iters=8, phase2_bf16_head=20)
    a = pg.make_fused_pipeline(**kw)(x0)
    b = pg.make_fused_pipeline(fused=counted, **kw)(x0)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert calls == ([20, 60] if adaptive else [8, 20, 60])
    assert bool((a[2] > 20).any())


def test_dict_pipeline_reaches_every_option():
    G, L = 2, 16
    _, pg = _pair(grouped_cartpoles(G, F32, N=N), **PIPE)
    x0 = _x0(G, L, 137, scale=0.8).astype(np.float32)
    a = pg.solve_batch(x0, method="fused", pipeline=(20, 16, 60))
    b = pg.solve_batch(x0, method="fused", pipeline=dict(
        phase1_iters=20, straggler_slots=16, phase2_iters=60))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = pg.solve_batch(x0, method="fused", pipeline=dict(
        phase1_iters=20, phase2_iters=60))  # the default slot count
    assert torch.equal(a[2], c[2])
    with pytest.raises(TypeError, match="batch_tile"):
        pg.solve_batch(x0, method="fused", pipeline=dict(
            phase1_iters=20, phase2_iters=60, batch_tile=8))


@pytest.mark.parametrize("kw,match", [
    (dict(phase1_iters=50, phase2_iters=100), "phase1_iters"),
    (dict(phase1_iters=52, phase2_iters=101), "phase2_iters"),
    (dict(phase1_iters=52, phase2_iters=100, phase0_bf16_iters=6),
     "phase0_bf16_iters"),
    (dict(phase1_iters=52, phase2_iters=100, phase2_bf16_head=6),
     "phase2_bf16_head"),
    (dict(phase1_iters=52, phase2_iters=100, phase2_bf16_head=100),
     "phase2_bf16_head"),
    (dict(phase1_iters=52, phase2_iters=100, valid_lanes=17), "valid_lanes"),
    (dict(phase1_iters=52, phase2_iters=100, straggler_slots=0),
     "straggler_slots"),
])
def test_pipeline_validates_its_budgets(kw, match):
    _, pg = _pair(grouped_cartpoles(2, F32, N=N), max_iter=52,
                  en_state_bound=False, check_termination=4)
    with pytest.raises(ValueError, match=match):
        pg.make_fused_pipeline(lanes=16, **dict(dict(straggler_slots=8), **kw))


def test_refusals():
    groups = grouped_cartpoles(2, F32, N=N)
    _, pg = _pair(groups, max_iter=50, en_state_bound=False,
                  adaptive_rho=True)
    x0 = _x0(2, 8, 139).astype(np.float32)
    for kw in (dict(phase0_bf16_iters=10), dict(phase2_bf16_head=10)):
        with pytest.raises(ValueError, match="fixed-rho only"):
            pg.make_fused_pipeline(phase1_iters=50, phase2_iters=100,
                                   lanes=8, **kw)
    with pytest.raises(ValueError, match="lcm"):
        pg.make_fused_pipeline(phase1_iters=52, phase2_iters=100, lanes=8)
    pg.settings = pg.settings.replace(bf16_head_iters=5)
    with pytest.raises(ValueError, match="fixed-rho only"):
        pg.solve_batch(x0, method="fused")
    pg.settings = pg.settings.replace(bf16_head_iters=0,
                                      adaptive_rho_rebuild=True)
    with pytest.raises(ValueError, match="adaptive_rho_rebuild"):
        pg.solve_batch(x0, method="condensed")
    pg.settings = pg.settings.replace(adaptive_rho=False,
                                      adaptive_rho_rebuild=False)
    with pytest.raises(ValueError, match="only available with"):
        pg.solve_batch(x0, method="condensed", pipeline=(50, 8, 100))
    with pytest.raises(ValueError, match="unknown method"):
        pg.solve_batch(x0, method="chunked")
    with pytest.raises(ValueError, match="x0s must be"):
        pg.solve_batch(x0[0], method="fused")
    with pytest.raises(ValueError, match="leading group axis"):
        from tinympc_julia_tpu_torch.types import index_instance
        GroupedBatchSolver(index_instance(groups[1][0], 0),
                           index_instance(groups[1][1], 0))
    pg.settings = pg.settings.replace(max_iter=51, check_termination=2)
    with pytest.raises(ValueError, match="check_termination"):
        pg.solve_batch(x0, method="fused")
    _, p64 = _pair(grouped_cartpoles(2, F64, N=N), max_iter=50,
                   en_state_bound=False)
    with pytest.raises(TypeError, match="float32"):
        p64.solve_batch(_x0(2, 8, 139), method="fused")
    with pytest.raises(TypeError, match="float32"):
        p64.make_fused_pipeline(lanes=8)


def test_rebuild_rides_the_standard_method():
    """``adaptive_rho_rebuild`` is refused on the condensed and fused
    methods and runs on the standard one, as in the JAX package."""
    G, L = 2, 3
    jg, pg = _pair(grouped_cartpoles(G, F64, N=N), max_iter=12,
                   en_state_bound=False, adaptive_rho=True,
                   adaptive_rho_rebuild=True, adaptive_rho_min=0.3,
                   adaptive_rho_max=8.0)
    x0 = _x0(G, L, 149)
    p = pg.solve_batch(x0, method="standard")
    j = jg.solve_batch(x0, method="standard")
    np.testing.assert_array_equal(p[2].numpy(), j[2])
    np.testing.assert_allclose(p[1].numpy(), j[1], atol=1e-6, rtol=0)


def test_exports():
    assert PG.stack_instances is P.stack_instances
    assert P.parallel.GroupedBatchSolver is GroupedBatchSolver
