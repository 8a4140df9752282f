"""Kernel K1 of the port (ops/cuda/condensed_kernel.py): its plain PyTorch
version vs the JAX Pallas kernel (interpret mode off the TPU), vs the port's
condensed oracle, and the wrapper's dispatch on the CPU; with the box alone
and with the linear and cone projections (K1e), the group grid (K1d:
``num_groups``) and the reduced-precision product (K1c: ``precision``,
``bf16_head_iters``).  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tinympc_julia_tpu.ops.pallas.condensed_kernel import (
    make_condensed_fused_solver as jax_fused)
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.ops.cuda import _build
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K

from torch_port_common import (CPU, INTERPRET, cartpole_setup,
                               grouped_cartpoles, grouped_rockets,
                               jax_arrays, rocket_setup, rocket_x0, x0_batch)
from tinympc_julia_tpu.ops.condensed import build_condensed as jax_build
from tinympc_julia_tpu_torch.utils import convert

N = 20
CONFIGS = {
    "ct1-alpha1.7": dict(check_termination=1, relaxation_alpha=1.7,
                         en_state_bound=False, max_iter=80),
    "ct4": dict(check_termination=4, relaxation_alpha=1.7,
                en_state_bound=False, max_iter=80),
    "state-bounded": dict(check_termination=1, relaxation_alpha=1.0,
                          en_state_bound=True, max_iter=120),
}


def _kw(cfg, **extra):
    kw = dict(nx=4, nu=1, N=N, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
              en_input_bound=True, warm_start=False, carry_out=False)
    kw.update(cfg)
    kw.update(extra)
    return kw


def _bounds(p):
    return (p.u_min, p.u_max, p.x_min, p.x_max)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_matches_jax_kernel(name):
    """f32, B = 256, Pallas batch tile 128: more than half the lanes solve;
    on lanes both sides solved, identical counts and 1e-5 on states and
    controls; the carry within 1e-5."""
    cfg = CONFIGS[name]
    B = 256
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(
        jnp.float32, state_bound=cfg["en_state_bound"])
    x0 = x0_batch(B, 0).astype(np.float32)
    fn = jax_fused(4, 1, N, batch_tile=128, en_input_bound=True,
                   carry_out=True, interpret=INTERPRET, **cfg)
    jx, ju, jit, jok, jcar = fn(jm, jc.rho, jp.u_min, jp.u_max, jp.x_min,
                                jp.x_max, jnp.asarray(x0))
    px, pu, pit, pok, pcar = K.condensed_fused_reference(
        pm, float(pc.rho), *_bounds(pp), torch.as_tensor(x0), None,
        **_kw(cfg, carry_out=True))
    both = (np.asarray(jok) == 1) & (pok.numpy() == 1)
    assert both.sum() > B // 2
    np.testing.assert_array_equal(pit.numpy()[both], np.asarray(jit)[both])
    np.testing.assert_allclose(pu.numpy()[both], np.asarray(ju)[both],
                               atol=1e-5)
    np.testing.assert_allclose(px.numpy()[both], np.asarray(jx)[both],
                               atol=1e-5)
    for k in K.FusedCarry._fields:
        np.testing.assert_allclose(getattr(pcar, k).numpy(),
                                   np.asarray(getattr(jcar, k)), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_matches_condensed_oracle(name):
    """f64: the fused form (one T12 matmul per iteration) and the T1/T2
    condensed solve give identical per-lane counts on every lane."""
    cfg = CONFIGS[name]
    (_, _, _), (pp, pc, pm) = cartpole_setup(
        jnp.float64, state_bound=cfg["en_state_bound"])
    x0 = torch.as_tensor(x0_batch(128, 1, scale=1.0))
    _, pu, pit, pok = K.condensed_fused_reference(
        pm, pc.rho, *_bounds(pp), x0, None, **_kw(cfg))
    s = C.Settings(en_input_bound=True, **{k: cfg[k] for k in (
        "check_termination", "relaxation_alpha", "en_state_bound",
        "max_iter")})
    _, cu, cit, cok = C.solve_condensed(pp, pc, s, x0, pm)
    np.testing.assert_array_equal(pit.numpy(), cit.numpy())
    np.testing.assert_array_equal(pok.numpy(), cok.numpy())
    np.testing.assert_allclose(pu.numpy(), cu.numpy(), atol=1e-9)


@pytest.mark.parametrize("state_bound", [False, True],
                         ids=["state-free", "generic"])
def test_reference_warm_chain_equals_one_shot(state_bound):
    """30 iterations with carry_out, then 50 warm: bit for bit the
    80-iteration solve on every lane."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32,
                                             state_bound=state_bound)
    x0 = torch.as_tensor(x0_batch(128, 2, scale=1.0), dtype=torch.float32)
    cfg = dict(check_termination=1, relaxation_alpha=1.7,
               en_state_bound=state_bound)
    args = (pm, float(pc.rho), *_bounds(pp), x0)
    one = K.condensed_fused_reference(*args, None,
                                      **_kw(cfg, max_iter=80))
    xa, ua, ia, sa, carry = K.condensed_fused_reference(
        *args, None, **_kw(cfg, max_iter=30, carry_out=True))
    xb, ub, ib, sb = K.condensed_fused_reference(
        *args, carry, **_kw(cfg, max_iter=50, warm_start=True))
    done = sa == 1
    assert bool(done.any()) and bool((~done & (sb == 1)).any())
    assert torch.equal(torch.where(done, ia, 30 + ib), one[2])
    assert torch.equal(torch.maximum(sa, sb), one[3])
    assert torch.equal(torch.where(done[:, None, None], ua, ub), one[1])
    assert torch.equal(torch.where(done[:, None, None], xa, xb), one[0])
    if not state_bound:
        assert float(carry.g.abs().max()) == 0.0


def test_cpu_solver_runs_the_plain_version_and_builds_nothing():
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.as_tensor(x0_batch(64, 3), dtype=torch.float32)
    before = K.condensed_fused_cuda.launches
    fn = K.make_condensed_fused_solver(4, 1, N, max_iter=40,
                                       relaxation_alpha=1.7)
    out = fn(pm, pc.rho, *_bounds(pp), x0)
    ref = K.condensed_fused_reference(
        pm, pc.rho, *_bounds(pp), x0, None,
        **_kw(dict(check_termination=1, relaxation_alpha=1.7,
                   en_state_bound=False, max_iter=40)))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert K.condensed_fused_cuda.launches == before
    assert _build.load_library.cache_info().currsize == 0
    assert K._kernel_fn.cache_info().currsize == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.zeros((8, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.condensed_fused_cuda(pm, 1.0, *_bounds(pp), x0, None, **_kw(
            dict(check_termination=1, relaxation_alpha=1.0,
                 en_state_bound=False, max_iter=4)))
    assert _build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("kw,err", [
    (dict(check_termination=3, max_iter=100), ValueError),
    (dict(precision="bf16"), ValueError),
    (dict(bf16_head_iters=6, check_termination=4, max_iter=48), ValueError),
    (dict(bf16_head_iters=2, check_termination=4, max_iter=48), ValueError),
    (dict(bf16_head_iters=48, check_termination=4, max_iter=48), ValueError),
    (dict(num_groups=0), ValueError),
], ids=["ct", "precision-name", "head-off-cadence", "head-below-ct",
        "head-is-the-budget", "no-groups"])
def test_unported_and_invalid_options_raise(kw, err):
    with pytest.raises(err):
        K.make_condensed_fused_solver(4, 1, N, **kw)


def test_wrong_inputs_raise():
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    fn = K.make_condensed_fused_solver(4, 1, N, max_iter=8)
    with pytest.raises(ValueError, match="x0s"):
        fn(pm, pc.rho, *_bounds(pp), torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="warm"):
        fn(pm, pc.rho, *_bounds(pp), torch.zeros((8, 4)),
           K.FusedCarry(*(torch.zeros(1) for _ in range(5))))


def test_tile_plan():
    # tiles of 32 lanes on 256 threads.  Cartpole, sw = 99: 8 rows a thread
    # (128 padded rows); w2 99 x 32 floats + flags + residual partials + the
    # lanes' state (uxc 99, y and z 19 each, v 80: 217 floats a lane) + the
    # resident map 99 x 128 (the plan of its reduced and projected
    # launches; an fp32 box launch takes the warp layout: the map, its
    # bounds 2 x 99 floats, and 8 warps of w2 128 x 8 floats and 8 lanes'
    # state and staged carry, 217 + 198 floats a lane)
    tiles = K.TilePlan(32, 256, True, True, 128, 128,
                       12672 + 144 + 4096 + 27776 + 50688)
    assert K.shared_tile_plan(4, 1, 20) == tiles
    assert K.fused_tile_plan(4, 1, 20, projected=True) == tiles
    assert K.fused_tile_plan(4, 1, 20) == K.TilePlan(
        8, 256, True, True, 128, 128, 50688 + 800 + 8 * (4096 + 13280),
        lanes=4, warps=8)
    # quadrotor, sw = 316: 20 rows a thread (320 padded rows; in the fp32
    # product 10 rows x 4 lanes, the 4-lane layout), the state (708 floats
    # a lane) resident, T12 streamed through a ring of the bytes of six 8 x
    # 320 fp32 slabs (three 16-row slabs with 4 lanes a thread)
    plan = K.fused_tile_plan(12, 4, 20)
    assert plan == K.TilePlan(32, 256, False, True, 320, 320,
                              40448 + 144 + 4096 + 90624 + 6 * 8 * 320 * 4,
                              lanes=4)
    assert plan.smem <= K.SMEM_PER_BLOCK == 232448
    assert plan.tile % (2 * K.MMA_N) == 0
    # a state dual adds sx floats a lane
    assert K.state_floats(12, 4, 20, False) == 708 + 240
    # sw = 508 with a state dual: the state stays in global memory
    wide = K.fused_tile_plan(12, 4, 32, state_free=False)
    assert not wide.state_shared and not wide.resident and wide.rows == 512
    # sw = 790: two passes of 16 x 32 rows, the first pass's sums parked
    wider = K.fused_tile_plan(30, 10, 20)
    assert (wider.passes, wider.rpt, wider.rows) == (2, 32, 1024)
    assert wider.smem <= K.SMEM_PER_BLOCK


def test_tile_plan_for_wide_maps():
    """The quadrotor at N = 40 and 57 (sw 636, 908), widths a one-pass plan
    refused: w2 in shared memory, the product in passes of 16 RPT rows,
    every layout within one block's shared memory, the state in global
    memory beside w2; reduced iterations at 908 take 8 passes of 128 rows
    (the bf16 ring and the rounded w2 then fit); the widest maps a tile
    leaves room for.  From CLUSTER_FROM_WIDTH (sw 908, where the cluster
    first beat them on the card) the plan splits the tile over a
    cluster."""
    for N_, sw in ((40, 636), (57, 908)):
        for reduced in (False, True):
            for state_free in (True, False):
                plan = K.shared_tile_plan(12, 4, N_, reduced, state_free)
                assert plan.passes > 1 and not plan.state_shared
                assert plan.rows == plan.passes * K.TILE_ROW_GROUPS \
                    * plan.rpt
                assert plan.rows >= sw > plan.rows - plan.rows // plan.passes
                assert plan.smem <= K.SMEM_PER_BLOCK
                assert plan.kp >= sw and plan.kp % K.KP_ALIGN == 0
                assert K.fused_tile_plan(12, 4, N_, reduced, state_free) \
                    == (plan if sw < K.CLUSTER_FROM_WIDTH else
                        K.cluster_tile_plan(12, 4, N_, reduced))
    assert K.fused_tile_plan(12, 4, 40).rpt == 20
    lo = K.shared_tile_plan(12, 4, 57, reduced=True)
    assert (lo.passes, lo.rpt) == (8, 8)
    # the widest maps a tile leaves room for w2 in shared memory (sw 1,580
    # in fp32, 1,052 with reduced iterations); past them, and from
    # CLUSTER_FROM_WIDTH, the tile split over a cluster, 8 lanes x 8 rows a
    # thread in passes of 512 rows over a block's slice
    assert not K.shared_tile_plan(12, 4, 99).w2_global
    assert not K.shared_tile_plan(12, 4, 66, reduced=True).w2_global
    assert K.shared_tile_plan(12, 4, 100) is None
    assert K.shared_tile_plan(12, 4, 67, reduced=True) is None
    for N_, reduced in ((100, False), (67, True), (99, False)):
        p = K.fused_tile_plan(12, 4, N_, reduced)
        assert (p.tile, p.w2_global, p.rpt) == (32, False, K.CLUSTER_RPT)
        assert p.cluster in K.CLUSTER_SIZES
        assert p.rows == p.cluster * p.passes * K.TILE_ROW_GROUPS * 32 \
            >= 16 * N_ - 4
        assert p.smem <= K.SMEM_PER_BLOCK


def test_tile_iterations_count_each_tile_to_its_slowest_lane():
    counts = torch.tensor([3, 9, 1, 1, 7, 2, 2])
    assert K.tile_iterations(counts, 2) == 9 + 1 + 7 + 2
    assert K.tile_iterations(counts, 4) == 9 + 7
    # per group: a group's last tile is ragged, tiles never span groups
    assert K.tile_iterations(counts[:6], 2, groups=2) == 9 + 1 + 7 + 2
    assert K.tile_iterations(counts[:6], 4, groups=2) == 9 + 7


# -- K1e: the linear and cone projections ------------------------------------

ROCKET_KW = dict(nx=6, nu=3, N=10, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
                 en_input_bound=True, check_termination=1,
                 soc_u=((0, 3, 0.25),), soc_x=((0, 3, 0.5),))
A_LIN = np.array([[1.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.5]])
B_LIN = np.array([1.0, 0.8])


def _both_rocket(x0, max_iter, en_state_bound=True, **extra):
    """The JAX Pallas kernel (tile 64) and the port's factory on the CPU
    (the plain version), fp32, with the rocket's box and cones."""
    (jp, jc, jm), (pp, pc, pm) = rocket_setup(jnp.float32)
    kw = dict(ROCKET_KW, max_iter=max_iter, en_state_bound=en_state_bound,
              carry_out=True, **extra)
    nx, nu, N = kw.pop("nx"), kw.pop("nu"), kw.pop("N")
    j = jax_fused(nx, nu, N, batch_tile=64, interpret=INTERPRET, **kw)(
        jm, jc.rho, jp.u_min, jp.u_max, jp.x_min, jp.x_max,
        jnp.asarray(x0, jnp.float32))
    p = K.make_condensed_fused_solver(nx, nu, N, **kw)(
        pm, pc.rho, *_bounds(pp), torch.as_tensor(x0, dtype=torch.float32))
    return j, p


def test_rocket_cones_match_jax_kernel():
    """The rocket's thrust and glide-slope cones with the box (the JAX bench
    row's configuration), B = 128, 200 iterations: on lanes both solved,
    identical counts and 1e-4 (tests/test_pallas_fused.py's bar); the
    solutions satisfy the thrust cone."""
    x0 = rocket_x0(128).astype(np.float32)
    (jx, ju, jit, jok, _), (px, pu, pit, pok, _) = _both_rocket(x0, 200)
    both = (np.asarray(jok) == 1) & (pok.numpy() == 1)
    assert both.sum() > 64
    np.testing.assert_array_equal(pit.numpy()[both], np.asarray(jit)[both])
    np.testing.assert_allclose(pu.numpy()[both], np.asarray(ju)[both],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(px.numpy()[both], np.asarray(jx)[both],
                               atol=1e-4, rtol=1e-4)
    uu = pu.numpy()[both]
    assert (np.linalg.norm(uu[..., :2], axis=-1)
            <= 0.25 * uu[..., 2] + 5e-3).all()


def test_halfspaces_match_jax_kernel():
    """Two state halfspaces and no state box on the cartpole (the generic g
    path without a state bound), B = 128, 150 iterations: >= 95% of the
    lanes both solved have equal counts, all within one check, 1e-4 on
    those with equal counts (tests/test_pallas_fused.py's rule)."""
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = x0_batch(128, 4).astype(np.float32)
    kw = dict(max_iter=150, en_input_bound=True, en_state_bound=False,
              lin_x=(A_LIN, B_LIN))
    jx, ju, jit, jok = jax_fused(4, 1, N, batch_tile=64, interpret=INTERPRET,
                                 **kw)(jm, jc.rho, jp.u_min, jp.u_max,
                                       jp.x_min, jp.x_max, jnp.asarray(x0))
    px, pu, pit, pok = K.make_condensed_fused_solver(4, 1, N, **kw)(
        pm, pc.rho, *_bounds(pp), torch.as_tensor(x0))
    both = (np.asarray(jok) == 1) & (pok.numpy() == 1)
    assert both.sum() > 64
    ita, itb = pit.numpy()[both], np.asarray(jit)[both]
    same = ita == itb
    assert same.mean() >= 0.95
    assert (np.abs(ita - itb) <= 1).all()
    np.testing.assert_allclose(pu.numpy()[both][same],
                               np.asarray(ju)[both][same], atol=1e-4,
                               rtol=1e-4)
    xs = px.numpy()[both]
    assert (xs @ A_LIN.T - B_LIN).max() <= 5e-3


@pytest.mark.parametrize("case", ["active-state-cone", "box-off"])
def test_state_rule_matches_jax_kernel(case):
    """The state-free rule and the state clip: a state cone without a state
    box runs the generic path, carries a real state dual and matches the
    Pallas kernel; with the box switched off (but finite bounds in the
    problem) the states are not clipped.  "active-state-cone" hovers just
    inside the glide-slope cone, so the cone binds (and the lanes do not
    converge within the budget: all 40 iterations are compared);
    "box-off" starts 1.5x wider, beyond the |x_0| <= 5 bound the problem
    still holds."""
    if case == "active-state-cone":
        x0 = (np.array([4.0, 2.0, 9.2, 0.0, 0.0, 0.0])[None]
              * np.random.default_rng(7).uniform(0.99, 1.01, size=(64, 1)))
        max_iter = 40
    else:
        x0 = rocket_x0(64)
        x0[:, :2] *= 1.5
        max_iter = 200
    j, p = _both_rocket(x0.astype(np.float32), max_iter,
                        en_state_bound=False)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    for a, b in zip(p[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
    for k in K.FusedCarry._fields:
        np.testing.assert_allclose(getattr(p[4], k).numpy(),
                                   np.asarray(getattr(j[4], k)), atol=1e-3,
                                   rtol=1e-4, err_msg=k)
    if case == "active-state-cone":
        assert float(p[4].g.abs().max()) > 1.0
    else:
        assert int(p[3].sum()) == 64
        assert float(p[0][..., 0].max()) > 5.0  # x_max[0] = 5, not clipped


def test_rocket_warm_chain_equals_one_shot():
    """24 cold iterations with the carry, then 48 warm: bit for bit the
    72-iteration solve on every lane (the bench row's chain), with the
    generic path's state dual in the carry."""
    (_, _, _), (pp, pc, pm) = rocket_setup(jnp.float32)
    x0 = torch.as_tensor(rocket_x0(128), dtype=torch.float32)
    kw = dict(ROCKET_KW, en_state_bound=True)
    nx, nu, N_ = kw.pop("nx"), kw.pop("nu"), kw.pop("N")
    make = functools.partial(K.make_condensed_fused_solver, nx, nu, N_, **kw)
    args = (pm, pc.rho, *_bounds(pp), x0)
    one = make(max_iter=72)(*args)
    xa, ua, ia, sa, carry = make(max_iter=24, carry_out=True)(*args)
    xb, ub, ib, sb = make(max_iter=48, warm_start=True)(*args, carry)
    done = sa == 1
    assert not bool(done.any()) and bool((sb == 1).all())
    assert carry.g.shape == (60, 128)
    assert torch.equal(torch.where(done, ia, 24 + ib), one[2])
    assert torch.equal(torch.maximum(sa, sb), one[3])
    assert torch.equal(torch.where(done[:, None, None], ua, ub), one[1])
    assert torch.equal(torch.where(done[:, None, None], xa, xb), one[0])


def test_constrained_plain_version_matches_condensed_oracle():
    """f64: the fused form with cones, a halfspace and over-relaxation gives
    the per-lane counts of the T1/T2 condensed solve on every lane."""
    (_, _, _), (pp, pc, pm) = rocket_setup(jnp.float64)
    A_u, b_u = np.array([[0.0, 0.0, 1.0]]), np.array([60.0])
    pp = pp.replace(Alin_u=torch.as_tensor(A_u), blin_u=torch.as_tensor(b_u))
    x0 = torch.as_tensor(rocket_x0(64, seed=3))
    s = C.Settings(abs_pri_tol=2e-3, abs_dua_tol=1e-3, en_state_bound=True,
                   en_input_bound=True, en_input_soc=True, en_state_soc=True,
                   en_input_linear=True, relaxation_alpha=1.5,
                   check_termination=2, max_iter=200)
    _, cu, cit, cok = C.solve_condensed(pp, pc, s, x0, pm)
    fn = K.make_condensed_fused_solver(
        6, 3, 10, max_iter=200, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
        en_state_bound=True, relaxation_alpha=1.5, check_termination=2,
        **K.problem_constraint_kw(pp, s))
    _, pu, pit, pok = fn(pm, pc.rho, *_bounds(pp), x0)
    assert int(pok.sum()) == 64
    np.testing.assert_array_equal(pit.numpy(), cit.numpy())
    np.testing.assert_allclose(pu.numpy(), cu.numpy(), atol=1e-9)


def test_constraint_options_are_checked():
    with pytest.raises(ValueError, match="does not fit"):
        K.fused_constraints(soc_u=((2, 3, 0.5),), nx=6, nu=3,
                            dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="Alin"):
        K.fused_constraints(lin_x=(np.ones((1, 5)), np.ones(1)), nx=6, nu=3,
                            dtype=torch.float32, device="cpu")
    cons = K.fused_constraints(lin_x=(np.zeros((0, 4)), np.zeros(0)), nx=4,
                               nu=1, dtype=torch.float32, device="cpu")
    assert cons.lin_x is None  # no rows: the state-free path stays
    wide = K.fused_constraints(soc_x=((0, 3, 0.5),), nx=16, nu=1,
                               dtype=torch.float32, device="cpu")
    # a stage of 16 entries is projected where it lies, in the scratch
    args = K._side_args(wide.lin_x, wide.cones_x, 16, "state")
    assert args[1] == 0 and args[4] == 1 and args[2] is not None


@pytest.mark.parametrize("shape,dims,shared", [
    ((6, 3, 10, False), (6, 3), True),     # the rocket's cones
    ((4, 1, 20, False), (4, 0), True),     # the cartpole's halfspaces
    ((20, 9, 20, False), (20, 9), True),   # the chain's 10 cones
    ((12, 4, 20, True), (0, 4), True),     # input cones beside free states
    ((12, 4, 20, False), (12, 0), False),  # the state dual fills the block
    ((12, 4, 6, False), (0, 0), False),    # box only: no buffers
], ids=["rocket", "cartpole", "chain", "quadrotor-input",
        "quadrotor-state", "box"])
def test_projected_stages_take_shared_buffers_where_they_fit(shape, dims,
                                                             shared):
    """A launch with halfspaces or cones projects each stage in a buffer of
    each thread's own, as wide as the widest projected stage, after the
    plan's layout in shared memory where it fits (the plan itself does not
    change), and in the lanes' rows of a global scratch where it does not;
    the block's constraint data (``data`` bytes) follows in shared memory
    where it fits, and is left out where it does not."""
    plan = K.fused_tile_plan(*shape[:3], state_free=shape[3],
                             projected=any(dims))
    smem, in_shared = K.launch_smem(plan, *dims)
    assert in_shared == shared
    buffers = 4 * K.THREADS * max(dims) if shared else 0
    assert smem == plan.smem + buffers
    assert smem <= K.SMEM_PER_BLOCK
    data = 1024
    with_data, kept = K.launch_smem(plan, *dims, data)
    assert kept == shared
    fits = plan.smem + buffers + data <= K.SMEM_PER_BLOCK
    assert with_data == plan.smem + buffers + (data if fits else 0)
    assert K.launch_smem(plan, *dims, K.SMEM_PER_BLOCK) == (smem, shared)


def test_constraint_bytes_follow_the_kernels_layout():
    """A block's copy of one group's constraint data (csrc/projections.cuh
    constraint_bytes): the cone pairs (8 bytes a cone) and mu (4), then
    the halfspace rows (2 dim + 1 floats each), each part 16-byte aligned;
    per-group data counts one group's slice."""
    rng = np.random.default_rng(11)
    cons = K.fused_constraints(
        soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
        lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)),
        soc_u=((0, 9, 2.0),), nx=20, nu=9, dtype=torch.float32,
        device="cpu")
    assert K.constraint_bytes(cons, 20, 9) == 96 + 48 + 4 * 4 * 41
    grouped = K.fused_constraints(
        soc_x=((0, 3, np.array([0.5, 0.4])),),
        lin_x=(np.ones((2, 3, 6)), np.ones((2, 3))), nx=6, nu=3,
        dtype=torch.float32, device="cpu", num_groups=2)
    assert K.constraint_bytes(grouped, 6, 3) == 16 + 16 + 160  # 39 floats
    box = K.fused_constraints(nx=6, nu=3, dtype=torch.float32, device="cpu")
    assert K.constraint_bytes(box, 6, 3) == 0


# -- K1d: the group grid -----------------------------------------------------

NG = 8  # horizon of the grouped cases


def _grouped_maps(jps, jcs):
    jm = jax_build(jps, jcs)
    return jm, convert.maps_from_numpy(jax_arrays(jm), dtype=torch.float32,
                                       device=CPU)


def _assert_lanes_match(j, p, atol=1e-5, ct=1):
    """Equal counts on >= 95% of the lanes and within one check interval on
    the rest (an fp32 sum in another order may move a lane that sits on the
    tolerance); on the lanes with equal counts, equal verdicts, ``atol`` on
    states and controls, and on the carry (whose duals are not of order 1)
    ``atol`` with as much relative."""
    ip, ij = p[2].numpy(), np.asarray(j[2])
    same = ip == ij
    assert same.mean() >= 0.95 and (np.abs(ip - ij) <= ct).all()
    np.testing.assert_array_equal(p[3].numpy()[same], np.asarray(j[3])[same])
    for a, b in zip(p[:2], j[:2]):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   atol=atol)
    if len(p) > 4:
        for k in K.FusedCarry._fields:
            np.testing.assert_allclose(getattr(p[4], k).numpy()[:, same],
                                       np.asarray(getattr(j[4], k))[:, same],
                                       atol=atol, rtol=atol, err_msg=k)


@pytest.mark.parametrize("name,cfg", [
    ("ct1", dict(check_termination=1, relaxation_alpha=1.7,
                 en_state_bound=False, max_iter=60)),
    ("ct4", dict(check_termination=4, relaxation_alpha=1.7,
                 en_state_bound=False, max_iter=60)),
    ("state-bounds", dict(check_termination=2, relaxation_alpha=1.0,
                          en_state_bound=True, max_iter=60)),
])
def test_grouped_reference_matches_jax_kernel(name, cfg):
    """G = 3 randomised cartpoles x L = 16 lanes, per-group maps, rho and
    bounds: the plain version against the Pallas kernel's (G, tiles) grid,
    lane for lane, with the carry."""
    G, L = 3, 16
    (jps, jcs), (pps, pcs) = grouped_cartpoles(
        G, jnp.float32, N=NG, state_bound=cfg["en_state_bound"])
    jm, pm = _grouped_maps(jps, jcs)
    x0 = np.random.default_rng(3).uniform(-0.5, 0.5, size=(G, L, 4)).astype(
        np.float32)
    j = jax_fused(4, 1, NG, batch_tile=L, num_groups=G, en_input_bound=True,
                  carry_out=True, interpret=INTERPRET, **cfg)(
        jm, jcs.rho, jps.u_min, jps.u_max, jps.x_min, jps.x_max,
        jnp.asarray(x0))
    p = K.make_condensed_fused_solver(4, 1, NG, num_groups=G, carry_out=True,
                                      **cfg)(
        pm, pcs.rho, *_bounds(pps), torch.as_tensor(x0))
    _assert_lanes_match(j, p, ct=cfg["check_termination"])
    assert p[0].shape == (G * L, NG, 4) and p[4].w2.shape[1] == G * L
    assert int(p[3].sum()) > G * L // 2
    flat = K.make_condensed_fused_solver(4, 1, NG, num_groups=G,
                                         carry_out=True, **cfg)(
        pm, pcs.rho, *_bounds(pps), torch.as_tensor(x0).reshape(G * L, 4))
    for a, b in zip(p[:4], flat[:4]):
        assert torch.equal(a, b)  # flat x0s, lane = g*L + l


def test_grouped_reference_equals_per_group_solves():
    """Every group of a grouped solve equals the shared-problem solve of
    that group alone, bit for bit (float64), although the joint loop runs
    until the slowest group is done."""
    G, L = 3, 10
    _, (pps, pcs) = grouped_cartpoles(G, jnp.float64, N=NG)
    pm = C.build_condensed(pps, pcs)
    x0 = torch.as_tensor(np.random.default_rng(5).uniform(
        -0.5, 0.5, size=(G, L, 4)))
    kw = dict(nx=4, nu=1, N=NG, max_iter=80, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.7, check_termination=1, warm_start=False,
              carry_out=True)
    joint = K.condensed_fused_reference(pm, pcs.rho, *_bounds(pps), x0, None,
                                        num_groups=G, **kw)
    for g in range(G):
        one = K.condensed_fused_reference(
            C.CondensedMaps(*(m[g] for m in pm)), pcs.rho[g],
            pps.u_min[g], pps.u_max[g], pps.x_min[g], pps.x_max[g], x0[g],
            None, **kw)
        lanes = slice(g * L, (g + 1) * L)
        assert torch.equal(joint[2][lanes], one[2])
        torch.testing.assert_close(joint[1][lanes], one[1], atol=1e-12,
                                   rtol=0)
        torch.testing.assert_close(joint[4].w2[:, lanes], one[4].w2,
                                   atol=1e-12, rtol=0)


def test_grouped_rocket_per_group_cones_match_jax_kernel():
    """Per-group thrust and glide-slope cone coefficients (scalar bounds
    broadcast) on the group grid: counts equal on the lanes both solved,
    1e-4 on them (the rocket bar above)."""
    G, L = 2, 16
    (jps, jcs), (pps, pcs) = grouped_rockets(G, jnp.float32)
    jm, pm = _grouped_maps(jps, jcs)
    x0 = (rocket_x0(G * L, seed=6).reshape(G, L, 6)).astype(np.float32)
    kw = dict(max_iter=100, abs_pri_tol=2e-3, abs_dua_tol=1e-3,
              en_state_bound=True, en_input_bound=True, check_termination=1)
    j = jax_fused(6, 3, 10, batch_tile=L, num_groups=G, interpret=INTERPRET,
                  soc_u=((0, 3, np.asarray(jps.cones_u.mus)[:, 0]),),
                  soc_x=((0, 3, np.asarray(jps.cones_x.mus)[:, 0]),), **kw)(
        jm, jcs.rho, jps.u_min, jps.u_max, jps.x_min, jps.x_max,
        jnp.asarray(x0))
    s = C.Settings(en_input_soc=True, en_state_soc=True)
    p = K.make_condensed_fused_solver(
        6, 3, 10, num_groups=G, **kw, **K.problem_constraint_kw(pps, s))(
        pm, pcs.rho, *_bounds(pps), torch.as_tensor(x0))
    both = (np.asarray(j[3]) == 1) & (p[3].numpy() == 1)
    assert both.sum() > G * L // 2
    np.testing.assert_array_equal(p[2].numpy()[both], np.asarray(j[2])[both])
    np.testing.assert_allclose(p[1].numpy()[both], np.asarray(j[1])[both],
                               atol=1e-4, rtol=1e-4)
    mus = pps.cones_u.mus[:, 0].numpy()
    assert abs(mus[0] - mus[1]) > 1e-2
    for g in range(G):
        u = p[1].numpy()[g * L:(g + 1) * L][both[g * L:(g + 1) * L]]
        assert (np.linalg.norm(u[..., :2], axis=-1)
                <= mus[g] * u[..., 2] + 5e-3).all()


def test_grouped_per_group_halfspaces_match_jax_kernel():
    """Per-group halfspace rows (Alin (G, m, n), blin (G, m)) on the input
    side: each group's own bound binds, lane for lane with the Pallas
    kernel."""
    G, L = 2, 16
    (jps, jcs), (pps, pcs) = grouped_cartpoles(G, jnp.float32, N=NG)
    jm, pm = _grouped_maps(jps, jcs)
    Alin = np.ones((G, 1, 1))
    blin = np.array([[1.0], [2.5]])
    x0 = np.random.default_rng(7).uniform(-0.6, 0.6, size=(G, L, 4)).astype(
        np.float32)
    kw = dict(max_iter=80, en_input_bound=True, en_state_bound=False,
              lin_u=(Alin, blin))
    j = jax_fused(4, 1, NG, batch_tile=L, num_groups=G, interpret=INTERPRET,
                  **kw)(jm, jcs.rho, jps.u_min, jps.u_max, jps.x_min,
                        jps.x_max, jnp.asarray(x0))
    p = K.make_condensed_fused_solver(4, 1, NG, num_groups=G, **kw)(
        pm, pcs.rho, *_bounds(pps), torch.as_tensor(x0))
    _assert_lanes_match(j, p, atol=1e-4)
    u = p[1].numpy().reshape(G, L, -1)
    assert u[0].max() <= 1.0 + 1e-4 and u[1].max() <= 2.5 + 1e-4
    assert u[1].max() > 1.0 + 1e-2  # the looser group uses its room


def test_grouped_constraint_data_is_checked():
    with pytest.raises(ValueError, match="per-group"):
        K.fused_constraints(soc_u=((0, 3, np.ones(3)),), nx=6, nu=3,
                            dtype=torch.float32, device="cpu", num_groups=2)
    with pytest.raises(ValueError, match="group axis"):
        K.fused_constraints(lin_u=(np.ones((3, 1, 1)), np.ones((3, 1))),
                            nx=4, nu=1, dtype=torch.float32, device="cpu",
                            num_groups=2)
    cons = K.fused_constraints(soc_u=((0, 3, 0.3), (0, 3, np.array([.2, .4]))),
                               nx=6, nu=3, dtype=torch.float32, device="cpu",
                               num_groups=2)
    assert cons.cones_u.mus.shape == (2, 2)  # a scalar mu broadcasts
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    fn = K.make_condensed_fused_solver(4, 1, N, max_iter=8, num_groups=3)
    with pytest.raises(ValueError, match="groups"):
        fn(pm, pc.rho, *_bounds(pp), torch.zeros((8, 4)))
    with pytest.raises(ValueError, match="grouped x0s"):
        fn(pm, pc.rho, *_bounds(pp), torch.zeros((2, 4, 4)))


# -- K1c: the reduced-precision product and the head -------------------------

def _head_case(warm):
    """The shared cartpole, fp32, B = 32 (the first 8 lanes start so near
    the origin that they are done within 4 iterations), with a carry to
    start warm from."""
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = x0_batch(32, 11, scale=0.8).astype(np.float32)
    x0[:8] *= 1e-4
    jargs = (jm, jc.rho, jp.u_min, jp.u_max, jp.x_min, jp.x_max,
             jnp.asarray(x0))
    pargs = (pm, pc.rho, *_bounds(pp), torch.as_tensor(x0))
    base = dict(relaxation_alpha=1.7, en_state_bound=False)
    if not warm:
        return jargs, pargs, base
    jc0 = jax_fused(4, 1, N, batch_tile=32, max_iter=8, check_termination=4,
                    carry_out=True, interpret=INTERPRET, **base)(*jargs)[4]
    pc0 = K.make_condensed_fused_solver(4, 1, N, max_iter=8,
                                        check_termination=4, carry_out=True,
                                        **base)(*pargs)[4]
    return jargs + (jc0,), pargs + (pc0,), base


@pytest.mark.parametrize("name,warm,kw", [
    ("cold-head8-ct4", False, dict(max_iter=48, check_termination=4,
                                   bf16_head_iters=8)),
    ("cold-head1-ct1", False, dict(max_iter=40, check_termination=1,
                                   bf16_head_iters=1)),
    ("warm-head8-ct4", True, dict(max_iter=40, check_termination=4,
                                  bf16_head_iters=8)),
])
def test_head_control_flow_matches_jax_kernel(monkeypatch, name, warm, kw):
    """With the rounding switched off (off the TPU the Pallas kernel's
    DEFAULT precision is fp32 too), the head's control flow is the Pallas
    kernel's lane for lane: no check inside the head but on its last
    iteration (so no lane reports a count below k0 unless k0 - 1 is where
    it latched), a cold iteration 0 that is the pure rollout, cumulative
    counts, and the tail's ct cadence."""
    monkeypatch.setattr(K, "bf16_round", lambda t: t)
    jargs, pargs, base = _head_case(warm)
    j = jax_fused(4, 1, N, batch_tile=32, warm_start=warm, carry_out=True,
                  interpret=INTERPRET, **base, **kw)(*jargs)
    p = K.make_condensed_fused_solver(4, 1, N, warm_start=warm,
                                      carry_out=True, **base, **kw)(*pargs)
    _assert_lanes_match(j, p, ct=kw["check_termination"])
    k0 = kw["bf16_head_iters"]
    assert int(p[3].sum()) > 16
    nohead = K.make_condensed_fused_solver(
        4, 1, N, warm_start=warm, **base,
        **dict(kw, bf16_head_iters=0))(*pargs)
    # the easy lanes latch at the first check: the end of the head, which
    # without a head comes earlier
    assert int(p[2].min()) >= k0
    if k0 > kw["check_termination"]:
        early = nohead[2] < k0
        assert bool(early.any()) and bool((p[2][early] == k0).all())


def test_head_equals_the_chained_solves_bit_for_bit():
    """Rounding on: a head of k0 reduced iterations inside one solve equals
    a (k0, check_termination=k0, "default", carry out) solve chained into a
    warm full-precision solve, bit for bit, with cumulative counts; and the
    reduced product really differs from the full one."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.as_tensor(x0_batch(64, 13, scale=0.8), dtype=torch.float32)
    args = (pm, pc.rho, *_bounds(pp), x0)
    base = dict(relaxation_alpha=1.7, en_state_bound=False)
    k0, total, ct = 12, 72, 4
    head = K.make_condensed_fused_solver(
        4, 1, N, max_iter=total, check_termination=ct, bf16_head_iters=k0,
        carry_out=True, **base)(*args)
    a = K.make_condensed_fused_solver(
        4, 1, N, max_iter=k0, check_termination=k0, precision="default",
        carry_out=True, **base)(*args)
    b = K.make_condensed_fused_solver(
        4, 1, N, max_iter=total - k0, check_termination=ct, warm_start=True,
        carry_out=True, **base)(*args, a[4])
    done = a[3] == 1
    assert torch.equal(torch.where(done, a[2], k0 + b[2]), head[2])
    assert torch.equal(torch.maximum(a[3], b[3]), head[3])
    assert torch.equal(torch.where(done[:, None, None], a[1], b[1]), head[1])
    for k in K.FusedCarry._fields:
        assert torch.equal(getattr(b[4], k), getattr(head[4], k)), k
    full = K.make_condensed_fused_solver(
        4, 1, N, max_iter=total, check_termination=ct, **base)(*args)
    assert not torch.equal(full[1], head[1])
    assert int(head[3].sum()) >= int(full[3].sum()) - 2  # quality holds
    both = (full[3] == 1) & (head[3] == 1)
    assert float((full[1] - head[1])[both].abs().max()) < 2e-2


def test_a_reduced_phase_latches_only_on_true_residuals():
    """``precision="default"`` at ct = 1: every iteration runs the check, so
    every product is computed in full precision and the solve equals the
    full-precision one bit for bit; at ct = 4 the lanes it latches pass the
    tolerance when the residuals are recomputed in full precision from the
    latched carry."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.as_tensor(x0_batch(64, 17, scale=0.3), dtype=torch.float32)
    args = (pm, pc.rho, *_bounds(pp), x0)
    base = dict(relaxation_alpha=1.0, en_state_bound=False)
    lo1 = K.make_condensed_fused_solver(4, 1, N, max_iter=60,
                                        precision="default", **base)(*args)
    hi1 = K.make_condensed_fused_solver(4, 1, N, max_iter=60, **base)(*args)
    for a, b in zip(lo1, hi1):
        assert torch.equal(a, b)
    lo4 = K.make_condensed_fused_solver(
        4, 1, N, max_iter=120, check_termination=4, precision="default",
        carry_out=True, **base)(*args)
    latched = lo4[3] == 1
    assert bool(latched.any())
    # the carry froze before the latching iteration: one more full-precision
    # iteration from it must latch at once
    again = K.make_condensed_fused_solver(
        4, 1, N, max_iter=1, check_termination=1, warm_start=True,
        **base)(*args, lo4[4])
    assert bool((again[3][latched] == 1).all())
    assert torch.equal(again[1][latched], lo4[1][latched])


def test_bf16_round_is_round_to_nearest_even():
    t = torch.tensor([1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8,
                      1.0 + 2.0 ** -7, -0.1], dtype=torch.float32)
    r = K.bf16_round(t)
    assert r.dtype == torch.float32
    # ties go to the even mantissa: 1 + 2^-8 -> 1, 1 + 3*2^-8 -> 1 + 2^-6
    assert r[:4].tolist() == [1.0, 1.0, 1.0 + 2.0 ** -6, 1.0 + 2.0 ** -7]
    assert torch.equal(K.bf16_round(r), r)


def _mma(a, w):
    """One output of ``mma_product``: a (K,) row by a (K,) column."""
    return K.mma_product(torch.tensor([a], dtype=torch.float32),
                         torch.tensor(w, dtype=torch.float32)[:, None]).item()


def test_mma_product_sums_as_the_tensor_cores():
    """A k16 step's terms are cut to 25 bits below the largest unnormalised
    exponent and the sum is truncated to fp32; the steps add in fp32 with
    round to nearest even."""
    t = 1.5 * 2.0 ** -25  # a term 25 bits below 1: its half bit is cut
    # exact: 1 + 12 * 2^-25 = 1 + 3 * 2^-23; the tensor cores: 1 + 2^-22
    assert _mma([1.0] * 9, [1.0] + [t] * 8) == 1.0 + 2.0 ** -22
    assert _mma([1.0] * 9, [-1.0] + [-t] * 8) == -(1.0 + 2.0 ** -22)
    # 1.5 * 1.5 = 2.25 aligns by its exponent before normalising (0), so the
    # small terms keep their 2^-25 bit
    assert _mma([1.5] + [1.0] * 8, [1.5] + [t] * 8) == 2.25 + 2.0 ** -22
    # the sum is truncated: 1 + 0.75 ulp -> 1, not 1 + 1 ulp
    assert _mma([1.0, 1.0], [1.0, 3.0 * 2.0 ** -25]) == 1.0
    # ... but two k16 steps add to nearest: 1 + 0.75 ulp -> 1 + 1 ulp
    a = [1.0] + [0.0] * 15 + [1.0]
    assert _mma(a, [1.0] + [0.0] * 15 + [3.0 * 2.0 ** -25]) == 1.0 + 2.0 ** -23
    # shapes: grouped and shared operands, K not a multiple of 16; within
    # fp32 rounding of the float64 product
    rng = np.random.default_rng(0)
    A = K.bf16_round(torch.as_tensor(rng.normal(size=(3, 7, 37)),
                                     dtype=torch.float32))
    W = K.bf16_round(torch.as_tensor(rng.normal(size=(3, 37, 5)),
                                     dtype=torch.float32))
    for a, w in ((A, W), (A[0], W), (A, W[0])):
        got = K.mma_product(a, w)
        ref = a.double() @ w.double()
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert float((got.double() - ref).abs().max()) < 1e-5


def test_tile_plan_with_reduced_iterations():
    # resident maps: the bf16 map (rows x (kp + 8)) and the rounded w2
    # (32 x (kp + 8)) join them
    assert K.fused_tile_plan(4, 1, 20, reduced=True) == K.TilePlan(
        32, 256, True, True, 128, 128,
        12672 + 144 + 4096 + 27776 + 50688 + 2 * 128 * 136 + 2 * 32 * 136)
    assert K.fused_tile_plan(6, 3, 10, reduced=True) == K.TilePlan(
        32, 256, True, True, 128, 96,
        11136 + 144 + 4096 + 25728 + 44544 + 2 * 128 * 104 + 2 * 32 * 104)
    # quadrotor: the ring holds six fp32 slabs or four bf16 slabs of 16
    # map columns (rows padded by 8), the larger of the two; the rounded w2
    # is 32 x (320 + 8) bf16; within one block's shared memory, a tile
    # width that is a multiple of the mma's N
    plan = K.fused_tile_plan(12, 4, 20, reduced=True)
    ring = max(6 * 8 * 320 * 4, 4 * 320 * (16 + 8) * 2)
    assert plan == K.TilePlan(32, 256, False, True, 320, 320,
                              40448 + 144 + 4096 + 90624 + ring
                              + 2 * 32 * 328, lanes=4)
    assert plan.smem <= 232448 and plan.tile % K.MMA_N == 0


# -- the kernel-side layouts, made at every launch ----------------------------

def test_map_layout_follows_the_maps():
    """A layout reads the maps it is given: a replaced T1 and an in-place
    write to T12 both show in the next one, and the bf16 map is made for
    launches with reduced iterations only: T12w itself rounded to bf16,
    row-major, zero-padded to the plan's (rows, kp)."""
    _, (pps, pcs) = grouped_cartpoles(2, jnp.float32, N=NG)
    pm = C.build_condensed(pps, pcs)
    su, sw = (NG - 1) * 1, (NG - 1) * 1 + NG * 4
    plan = K.fused_tile_plan(4, 1, NG, reduced=True)
    t12t, a, t12c, tx0, t1c = K.map_layout(pm, 4, su, sw, False, plan)
    assert a is None
    other = pm._replace(T1=pm.T1 + 1.0)
    assert torch.equal(K.map_layout(other, 4, su, sw, False, plan)[3],
                       tx0 + 1.0)
    pm.T12.mul_(1.5)
    again = K.map_layout(pm, 4, su, sw, True, plan)
    assert torch.equal(again[0], 1.5 * t12t)
    lo = again[1]
    assert lo.dtype == torch.bfloat16 and lo.shape == (2, plan.rows, plan.kp)
    assert torch.equal(lo[:, :sw, :sw].float(),
                       K.bf16_round(pm.T12[..., :sw]))
    assert not torch.equal(lo[:, :sw, :sw].float(), pm.T12[..., :sw])
    assert float(lo[:, sw:].float().abs().max()) == 0.0
    assert float(lo[:, :, sw:].float().abs().max()) == 0.0


def test_map_layouts_keep_the_group_axis():
    """K1's and K2's kernel-side layouts of G-stacked maps: each group's
    slice is the single-map layout (transposed, rows zero-padded to the
    plan's rows, or K2's row block)."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    G = 3
    _, (pps, pcs) = grouped_cartpoles(G, jnp.float32, N=NG)
    pm = C.build_condensed(pps, pcs)
    su, sw = (NG - 1) * 1, (NG - 1) * 1 + NG * 4
    plan = K.fused_tile_plan(4, 1, NG)
    t12t, _, t12c, tx0, t1c = K.map_layout(pm, 4, su, sw, False, plan)
    swp = plan.rows
    assert t12t.shape == (G, sw, swp) and swp % (4 * K.TILE_ROW_GROUPS) == 0
    for g in range(G):
        one = C.CondensedMaps(*(m[g] for m in pm))
        o12t, _, o12c, ox0, o1c = K.map_layout(one, 4, su, sw, False, plan)
        assert torch.equal(t12t[g], o12t) and torch.equal(t12c[g], o12c)
        assert torch.equal(tx0[g], ox0) and torch.equal(t1c[g], o1c)
        assert torch.equal(o12t[:, :sw], one.T12[:, :sw].T)
        assert float(o12t[:, sw:].abs().max()) == 0.0
    pt = C.build_condensed_taylor(pps, pcs)
    kplan = K2.adaptive_tile_plan(4, 1, NG, 2, reduced=True)
    t1t, t2t, t1a, t2a = K2.map_layout(pt, su, sw, kplan, True)
    assert t1t.shape == (G, 3, su + 4 + 1, kplan.ld1)
    assert t2t.shape == (G, sw + 1, kplan.ld2)
    assert t1a.shape == (G, 3, kplan.ld1, kplan.kp1)
    assert t2a.shape == (G, kplan.ld2, kplan.kp2)
    for g in range(G):
        o1t, o2t, o1a, o2a = K2.map_layout(
            C.CondensedTaylorMaps(*(m[g] for m in pt)), su, sw, kplan, True)
        assert torch.equal(t1t[g], o1t) and torch.equal(t2t[g], o2t)
        assert torch.equal(t1a[g], o1a) and torch.equal(t2a[g], o2a)
        assert torch.equal(o1t[:, :, :sw], pt.T1s[g].transpose(-1, -2))
        assert float(o1t[:, :, sw:].abs().max()) == 0.0
        # row 4 r + c of the transposed stack is row r of T2 block c
        for c in range(4):
            assert torch.equal(o2t[:-1, c:4 * su:4],
                               pt.T2s[g][c, :, :sw].T)
            assert torch.equal(o2t[-1, c:4 * su:4], pt.T2s[g][c, :, -1])
            assert torch.equal(o2a[c:4 * su:4, :sw].float(),
                               K.bf16_round(pt.T2s[g][c, :, :sw]))
        assert float(o2t[:, 4 * su:].abs().max()) == 0.0
        assert torch.equal(o1a[:, :sw, :su + 5].float(),
                           K.bf16_round(pt.T1s[g]))
        assert float(o1a[:, :, su + 5:].float().abs().max()) == 0.0
    assert K2.map_layout(pt, su, sw, kplan, False)[2:] == (None, None)


# -- the lifted shapes ---------------------------------------------------------

def _quad_solver(solver, horizon, **settings):
    from tinympc_julia_tpu.models import quadrotor
    solver.setup(quadrotor.A, quadrotor.B, None, np.diag(quadrotor.Q_DIAG),
                 np.diag(quadrotor.R_DIAG), quadrotor.RHO, 12, 4, horizon)
    solver.set_bound_constraints(np.full((12, horizon), -1e17),
                                 np.full((12, horizon), 1e17),
                                 np.full((4, horizon - 1), -0.5),
                                 np.full((4, horizon - 1), 0.5))
    solver.update_settings(**settings)
    return solver


def test_wide_map_solve_batch_matches_jax():
    """The quadrotor at N = 110 (sw 1,756), wider than a tile's w2 in
    shared memory leaves room for (the card splits the tile over a thread
    block cluster there): JAX's
    ``solve_batch(method="fused")`` (the Pallas kernel in interpret mode
    off the TPU) against the port's on the CPU (the plain version), f32,
    B = 8, 20 iterations, both from the JAX side's f32 cache: the same
    counts and flags, and 1e-5 on the states and controls of every lane
    (after 20 iterations none has converged yet)."""
    import tinympc_julia_tpu as J
    import tinympc_julia_tpu_torch as P
    horizon = 110
    assert K.fused_tile_plan(12, 4, horizon).cluster > 1
    settings = dict(max_iter=20, relaxation_alpha=1.7)
    js = _quad_solver(J.TinyMPCSolver(dtype=jnp.float32), horizon, **settings)
    ps = _quad_solver(P.TinyMPCSolver(dtype=torch.float32, device="cpu"),
                      horizon, **settings)
    c = js.cache
    ps.set_cache_terms(*(np.asarray(t) for t in (c.Kinf, c.Pinf, c.Quu_inv,
                                                 c.AmBKt)))
    x0 = np.random.default_rng(23).uniform(-0.05, 0.05, (8, 12)).astype(
        np.float32)
    jx, ju, jit, jok = js.solve_batch(x0, method="fused")
    px, pu, pit, pok = ps.solve_batch(x0, method="fused")
    np.testing.assert_array_equal(pit.numpy(), jit)
    np.testing.assert_array_equal(pok.numpy(), jok)
    np.testing.assert_allclose(pu.numpy(), ju, atol=1e-5)
    np.testing.assert_allclose(px.numpy(), jx, atol=1e-5)


def test_wide_stage_and_many_cones_match_jax_kernel():
    """K1e on the 20-state chain at N = 8: a state stage of 20 entries (the
    kernel once held 12) with 10 cones of dim 2 (mu 0.5; it once took 8),
    4 halfspace rows and the box, B = 64, 40 iterations, against the
    Pallas kernel in interpret mode: equal counts and flags, 1e-5 on the
    states and controls (the cones keep most lanes from converging, so
    every lane is compared); the carry, whose duals reach tens, at the
    state-rule test's 1e-3 / rtol 1e-4."""
    from torch_port_common import chain_plant, chain_x0, plant_setup
    A, B = chain_plant()
    Nc = 8
    (jp, jc, jm), (pp, pc, pm) = plant_setup(
        A, B, np.ones(20), np.ones(9), 1.0, Nc, jnp.float32, ub=1.0,
        x_bound=3.0)
    rng = np.random.default_rng(11)
    kw = dict(max_iter=40, en_state_bound=True, relaxation_alpha=1.7,
              carry_out=True, soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
              lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)))
    x0 = chain_x0(64, 12).astype(np.float32)
    j = jax_fused(20, 9, Nc, batch_tile=32, interpret=INTERPRET, **kw)(
        jm, jc.rho, jp.u_min, jp.u_max, jp.x_min, jp.x_max, jnp.asarray(x0))
    p = K.make_condensed_fused_solver(20, 9, Nc, **kw)(
        pm, pc.rho, *_bounds(pp), torch.as_tensor(x0))
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(j[3]))
    for a, b in zip(p[:2], j[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for k in K.FusedCarry._fields:
        np.testing.assert_allclose(getattr(p[4], k).numpy(),
                                   np.asarray(getattr(j[4], k)), atol=1e-3,
                                   rtol=1e-4, err_msg=k)


# the widths up to which the JAX package keeps condensed maps
# (AUTO_CONDENSED_BUDGET_BYTES): the fixed-rho and the adaptive maps
BUDGET_FIXED = [(12, 4, 387), (4, 1, 1295), (6, 3, 643)]
BUDGET_ADAPTIVE = [(12, 4, 213), (4, 1, 718), (6, 3, 352)]


def _check_slices(nx, nu, N_, blocks, stages, per_block):
    """A cluster's stage bounds: whole stages, each block at least one,
    the blocks' rows covering the map's in order, each within its padded
    ``per_block`` rows, and as even as whole stages allow."""
    sw = (N_ - 1) * nu + N_ * nx
    assert len(stages) == blocks + 1
    assert stages[0] == 0 and stages[-1] == 2 * N_ - 1
    assert all(a < b for a, b in zip(stages[:-1], stages[1:]))
    spans = K.slice_rows(nx, nu, N_, stages)
    starts = {0}
    for k in range(2 * N_ - 1):
        starts.add(max(starts) + (nu if k < N_ - 1 else nx))
    assert spans[0][0] == 0 and spans[-1][1] == sw
    for c, (a, b) in enumerate(spans):
        assert a in starts and b in starts  # on stage boundaries
        assert 0 < b - a <= per_block
        if c:
            assert a == spans[c - 1][1]
            assert abs(a - c * sw / blocks) <= max(nx, nu)


@pytest.mark.parametrize("shape,blocks", [
    (BUDGET_FIXED[0], 7), (BUDGET_FIXED[1], 7), (BUDGET_FIXED[2], 8)],
    ids=["quadrotor", "cartpole", "rocket"])
@pytest.mark.parametrize("reduced", [False, True], ids=["fp32", "reduced"])
def test_fixed_rho_plan_at_the_budget_width(shape, blocks, reduced):
    """K1 at the widest map the JAX package condenses: a tile of 32 lanes
    split over a thread block cluster, each block a slice of whole stages
    with its rows of w2 in its shared memory (the bf16 w2 of reduced
    iterations in global memory), 8 lanes x 8 rows a thread in passes of
    512 rows; the cluster size whose passes cost the card least."""
    nx, nu, N_ = shape
    sw = (N_ - 1) * nu + N_ * nx
    for state_free in (True, False):
        p = K.fused_tile_plan(nx, nu, N_, reduced, state_free)
        assert (p.tile, p.w2_global, p.rpt, p.resident, p.state_shared) \
            == (32, False, K.CLUSTER_RPT, False, False)
        assert p.cluster == blocks
        assert p.stages == K.stage_slices(nx, nu, N_, blocks)
        assert p.rows == blocks * p.passes * 512 >= sw
        _check_slices(nx, nu, N_, blocks, p.stages, p.passes * 512)
        rows = max(b - a for a, b in K.slice_rows(nx, nu, N_, p.stages))
        assert p.smem == K.cluster_smem(rows, reduced)
        assert p.smem <= K.SMEM_PER_BLOCK
        assert p == K.cluster_tile_plan(nx, nu, N_, reduced, blocks=blocks)
        # no cluster size whose slices fit costs the card less
        cost = K.pass_cost(rows) * blocks / K.CLUSTER_SMS[blocks]
        for C in K.CLUSTER_SIZES:
            other = K.cluster_tile_plan(nx, nu, N_, reduced, blocks=C)
            if other is not None:
                r = max(b - a for a, b in K.slice_rows(nx, nu, N_,
                                                        other.stages))
                assert K.pass_cost(r) * C / K.CLUSTER_SMS[C] >= cost


@pytest.mark.parametrize("shape", [(12, 4, 150), (12, 4, 60), (4, 1, 300),
                                   (6, 3, 100), (20, 9, 40)],
                         ids=["quadrotor150", "quadrotor60", "cartpole300",
                              "rocket100", "chain40"])
def test_cluster_slices_end_on_stage_boundaries(shape):
    """Every cluster size's slices (K1's and K2's stage bounds, K2's input
    stages of d) are whole stages, in order, as even as stages allow."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    nx, nu, N_ = shape
    for C in K.CLUSTER_SIZES:
        stages = K.stage_slices(nx, nu, N_, C)
        _check_slices(nx, nu, N_, C, stages, 1 << 30)
        p2 = K2.cluster_adaptive_plan(nx, nu, N_, 2, blocks=C)
        if p2 is not None:
            assert p2.stages == stages
            u = p2.ustages
            assert u[0] == 0 and u[-1] == N_ - 1
            assert all(0 < b - a for a, b in zip(u[:-1], u[1:]))
            assert max(b - a for a, b in zip(u[:-1], u[1:])) \
                - min(b - a for a, b in zip(u[:-1], u[1:])) <= 1
    assert K.stage_slices(12, 4, 3, 8) is None  # 5 stages, 8 blocks


@pytest.mark.parametrize("horizon", [1000, 3000], ids=["n1000", "n3000"])
def test_width_past_a_cluster_of_8_still_gets_a_plan(horizon):
    """Past a cluster of 8's slices in shared memory (the quadrotor at N =
    1,000, sw 15,996; 3,000), K1 keeps w2 and K2 its iterates in global
    memory streamed beside the maps, whose shared memory does not depend on
    the width: no cap comes back."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    for reduced in (False, True):
        assert K.cluster_tile_plan(12, 4, horizon, reduced) is None
        p = K.fused_tile_plan(12, 4, horizon, reduced)
        assert (p.cluster, p.w2_global, p.rpt) == (1, True, K.W2_GLOBAL_RPT)
        assert p.rows >= 16 * horizon - 4
        assert p.smem == K.fused_tile_plan(12, 4, 200 * 10, reduced).smem
        assert p == K.global_tile_plan(12, 4, horizon, reduced)
        assert K2.cluster_adaptive_plan(12, 4, horizon, 2, reduced) is None
        q = K2.adaptive_tile_plan(12, 4, horizon, 2, reduced)
        assert (q.cluster, q.iterates_global) == (1, True)
        assert q.ld1 >= 16 * horizon - 4 and q.smem <= K.SMEM_PER_BLOCK
        assert q == K2.global_adaptive_plan(12, 4, horizon, 2, reduced)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_cluster_size_follows_the_cards_busy_sms(kernel):
    """A launch weighs each cluster size by the SMs the card's occupancy
    API says its clusters keep busy (``busy_sms``): the CLUSTER_SMS table
    gives the table's plan; a size the card cannot hold is passed over for
    the next cheapest; where it holds none, the global layout stays."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    if kernel == "K1":
        def plan(N_, busy):
            return K.fused_tile_plan(12, 4, N_, busy_sms=busy)

        def glob(N_):
            return K.global_tile_plan(12, 4, N_)
    else:
        def plan(N_, busy):
            return K2.adaptive_tile_plan(12, 4, N_, 2, busy_sms=busy)

        def glob(N_):
            return K2.global_adaptive_plan(12, 4, N_, 2)
    for N_ in (150, 213):
        table = plan(N_, None)
        assert table.cluster > 1
        assert plan(N_, lambda p: K.CLUSTER_SMS[p.cluster]) == table
        other = plan(N_, lambda p: 0 if p.cluster == table.cluster
                     else K.CLUSTER_SMS[p.cluster])
        assert other.cluster not in (1, table.cluster)
        assert plan(N_, lambda p: 0) == glob(N_)


# the plans at the main shapes as 9d6d48e made them: (shape, reduced,
# state_free) -> K1's TilePlan fields, K2's AdaptivePlan fields (order 2)
MAIN_SHAPE_PLANS = [
    # the cartpole's fp32 launches (box constraints only): the warp layout,
    # 8 warps of lane groups of 8 lanes (the last two fields: 4 lanes a
    # thread, 8 warps), room for a staged carry
    ((4, 1, 20), False, True, (8, 256, True, True, 128, 128, 190496, 1, False,
                               1, (), 4, 8),
     (32, 256, 8, 1, 1, True, True, 32, 128, 131728, False)),
    ((4, 1, 20), False, False, (8, 256, True, True, 128, 128, 210976, 1,
                                False, 1, (), 4, 8),
     (32, 256, 8, 1, 1, True, True, 32, 128, 141968, False)),
    ((4, 1, 20), True, True, (32, 256, True, True, 128, 128, 138896, 1, False),
     (32, 256, 8, 1, 1, True, True, 32, 128, 205968, False)),
    ((4, 1, 20), True, False, (32, 256, True, True, 128, 128, 149136, 1,
                               False),
     (32, 256, 8, 1, 1, True, True, 32, 128, 216208, False)),
    ((6, 3, 10), False, True, (32, 256, True, True, 128, 96, 85648, 1, False),
     (32, 256, 8, 1, 1, True, True, 64, 96, 140176, False)),
    ((6, 3, 10), False, False, (32, 256, True, True, 128, 96, 93328, 1, False),
     (32, 256, 8, 1, 1, True, True, 64, 96, 147856, False)),
    ((6, 3, 10), True, True, (32, 256, True, True, 128, 96, 118928, 1, False),
     (32, 256, 8, 1, 1, True, True, 64, 96, 228752, False)),
    ((6, 3, 10), True, False, (32, 256, True, True, 128, 96, 126608, 1,
                               False),
     (32, 256, 8, 1, 1, False, True, 64, 96, 81808, False)),
    # the quadrotor at N = 20: K1's and K2's 4-lane layouts (lanes 4, the
    # last field; K2's maps' rows padded to 320 and 312, the field before)
    ((12, 4, 20), False, True, (32, 256, False, True, 320, 320, 196752, 1,
                                False, 1, (), 4),
     (32, 256, 20, 1, 1, False, True, 96, 320, 176272, False, 1, (), (),
      (320, 312), 4)),
    ((12, 4, 20), False, False, (32, 256, False, True, 320, 320, 227472, 1,
                                 False, 1, (), 4),
     (32, 256, 20, 1, 1, False, True, 96, 320, 206992, False, 1, (), (),
      (320, 312), 4)),
    ((12, 4, 20), True, True, (32, 256, False, True, 320, 320, 217744, 1,
                               False, 1, (), 4),
     (32, 256, 20, 1, 1, False, True, 96, 320, 197264, False, 1, (), (),
      (320, 312), 4)),
    ((12, 4, 20), True, False, (32, 256, False, False, 320, 320, 127120, 1,
                                False, 1, (), 4),
     (32, 256, 20, 1, 1, False, True, 96, 320, 227984, False, 1, (), (),
      (320, 312), 4)),
    # the quadrotor at N = 32 and 40: K2's 4-lane layout in passes (2 + 2:
    # the forward's of 320 rows, the backward's of 384), the maps laid out
    # pass by pass (640 + 624 rows at N = 40), the ring's slots 384 rows
    # wide; K1's 2 lanes a thread
    ((12, 4, 32), False, True, (32, 256, False, False, 512, 512, 167568, 1,
                                False),
     (32, 256, 20, 2, 2, False, False, 160, 512, 169104, False, 1, (), (),
      (512, 504), 4)),
    ((12, 4, 32), True, False, (32, 256, False, False, 512, 512, 200848, 1,
                                False),
     (32, 256, 20, 2, 2, False, False, 160, 512, 202384, False, 1, (), (),
      (512, 504), 4)),
    ((12, 4, 40), False, True, (32, 256, False, False, 640, 640, 147088, 2,
                                False),
     (32, 256, 20, 2, 2, False, False, 192, 640, 189584, False, 1, (), (),
      (640, 624), 4)),
    ((12, 4, 40), True, False, (32, 256, False, False, 640, 640, 188560, 2,
                                False),
     (32, 256, 20, 2, 2, False, False, 192, 640, 231056, False, 1, (), (),
      (640, 624), 4)),
]


@pytest.mark.parametrize("tiles", [None, 512, 2048],
                         ids=["any-batch", "16384-lanes", "65536-lanes"])
@pytest.mark.parametrize("shape,reduced,state_free,k1,k2", MAIN_SHAPE_PLANS,
                         ids=[f"{s[0][0]}x{s[0][1]}-N{s[0][2]}"
                              f"-{'lo' if s[1] else 'fp32'}"
                              f"-{'free' if s[2] else 'dual'}"
                              for s in MAIN_SHAPE_PLANS])
def test_main_shape_plans_are_unchanged(shape, reduced, state_free, k1, k2,
                                        tiles):
    """The cartpole at N = 20, the rocket at N = 10 and the quadrotor at N
    = 20, 32 and 40 keep the plans they had before the cluster layout,
    field for field: no cluster, nothing in global memory; K1's and K2's
    at the quadrotor's N = 20 take 4 lanes a thread in their fp32 products
    (the 4-lane layouts, faster on the card at every batch measured:
    PERF.md section 6; K2's maps' rows padded to its threads' rows), and
    so do K2's at N = 32 and 40 in passes (its maps laid out pass by
    pass), the rest 2; but the cartpole's fp32 launches take the warp
    layout (faster on the card at every batch measured: PERF.md section
    6), and the rocket's plan is that of its launches, which project its
    cones.  K2's are the same for the bulk batches
    (``tiles`` of 32 lanes: the adaptive pipeline's 16,384 lanes, the
    headline's 65,536) under the batch-aware plan, on an H100's 132 SMs."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    p = K.fused_tile_plan(*shape, reduced, state_free,
                          projected=shape == (6, 3, 10))
    assert p == K.TilePlan(*k1) and (p.cluster, p.stages) == (1, ())
    q = K2.adaptive_tile_plan(*shape, 2, reduced, state_free, tiles=tiles,
                              sms=132)
    assert q == K2.AdaptivePlan(*k2) and (q.cluster, q.stages) == (1, ())


@pytest.mark.parametrize("shape,lanes4", [
    ((12, 4, 20), True),    # sw 316: one pass of 320 rows, map streamed
    ((12, 4, 32), False),   # 32 rows a thread (sw 508)
    ((12, 4, 40), False),   # two passes (sw 636)
    ((4, 1, 20), False),    # the cartpole: its map resident
    ((6, 3, 10), False),    # the rocket: its map resident
    ((12, 4, 60), False),   # the cluster's widths
], ids=["quad-n20", "quad-n32", "quad-n40", "cartpole", "rocket",
        "quad-n60"])
def test_four_lane_plan(shape, lanes4):
    """A plan that streams its map in one pass of 320 rows takes the 4-lane
    layout (10 rows x 4 lanes a thread in the fp32 product, slabs of 16
    k-rows), whatever the batch, with room left for its ring's barriers;
    every other plan of tiles keeps 2 lanes a thread and 8-row slabs (the
    cartpole's and the rocket's fp32 launches with box constraints only
    take the warp layout, with no ring)."""
    for reduced in (False, True):
        for state_free in (True, False):
            p = K.fused_tile_plan(*shape, reduced, state_free)
            base = K.shared_tile_plan(*shape, reduced, state_free)
            if lanes4:
                assert p == base._replace(lanes=4)
                assert (p.rpt, p.passes, p.resident, p.slab_k) == (20, 1,
                                                                   False, 16)
                assert p.smem + K.RING_BARS_BYTES <= K.SMEM_PER_BLOCK
            else:
                sw = (shape[2] - 1) * shape[1] + shape[2] * shape[0]
                if sw <= K.WARP_ROWS and not reduced:  # the warp layout
                    assert p == K.warp_tile_plan(*shape, state_free)
                    assert not p.bulk_ring
                    p = K.fused_tile_plan(*shape, reduced, state_free,
                                          projected=True)
                assert p.lanes == 2
                assert p.slab_k == (16 if p.cluster > 1 else 8)


@pytest.mark.parametrize("shape,blocks", [
    (BUDGET_ADAPTIVE[0], 7), (BUDGET_ADAPTIVE[1], 8), (BUDGET_ADAPTIVE[2], 5)],
    ids=["quadrotor", "cartpole", "rocket"])
@pytest.mark.parametrize("reduced", [False, True], ids=["fp32", "reduced"])
def test_adaptive_plan_at_the_budget_width(shape, blocks, reduced):
    """K2 at the widest Taylor maps the JAX package condenses: a tile of 32
    lanes split over a thread block cluster, block c the rows of ux of
    whole stages and the rows of d of whole input stages in its shared
    memory; the cluster size whose passes cost the card least."""
    from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
    nx, nu, N_ = shape
    sw, su = (N_ - 1) * nu + N_ * nx, (N_ - 1) * nu
    for state_free in (True, False):
        p = K2.adaptive_tile_plan(nx, nu, N_, 2, reduced, state_free)
        assert (p.tile, p.iterates_global, p.rpt, p.resident,
                p.state_shared) == (32, False, K2.K2_CLUSTER_RPT, False,
                                    False)
        assert p.cluster == blocks
        assert p.ld1 == blocks * p.passes1 * 512 >= sw
        assert p.ld2 == blocks * p.passes2 * 512 >= 4 * su
        _check_slices(nx, nu, N_, blocks, p.stages, p.passes1 * 512)
        assert max(b - a for a, b in zip(p.ustages[:-1], p.ustages[1:])) \
            * 4 * nu <= p.passes2 * 512
        assert p.smem <= K.SMEM_PER_BLOCK


@pytest.mark.parametrize("nx,nu,N_,state_bound,layout", [
    (64, 64, 20, False, "wide"), (64, 64, 20, True, "wide"),
    (12, 4, 1000, False, "far"), (12, 4, 1000, True, "far"),
    (16, 16, 200, True, "far"), (4, 1, 8000, True, "far-stage"),
    (128, 128, 10, True, "far-wide")])
def test_stage_plan_at_lifted_shapes(nx, nu, N_, state_bound, layout):
    """K3 beyond the generic variant's 16 (the wide variant: lane groups of
    16 threads at 64, 32 at 128, the stage vectors in shared memory) and
    beyond a warp of lanes' workspace in shared memory (the far layout:
    the workspace in global memory; at 128 x 128 the matrices too, and at
    the cartpole's N = 8,000 the per-stage terms)."""
    from tinympc_julia_tpu_torch.ops.cuda import fused as K3
    for batch in (64, 16384):
        p = K3.fused_stage_plan(nx, nu, N_, state_bound, batch, 132)
        assert p.smem <= K3.SMEM_PER_BLOCK and p.threads % 32 == 0
        assert p.workspace_global == layout.startswith("far")
        if layout.endswith("wide"):
            assert not p.registers and p.group == {64: 16, 128: 32}[nx]
        assert p.matrices_global == (layout == "far-wide")
        assert p.stage_global == (layout == "far-stage")
        if layout.startswith("far") and layout != "far-wide":
            assert (p.group, p.registers) == K3.lane_group(nx, nu)


def test_side_of_64_entries_with_16_cones():
    """A projected stage of 64 entries with 16 cones and 3 halfspace rows:
    the side's arguments carry all of them (the cones' pairs on the
    device)."""
    cons = K.fused_constraints(
        soc_x=tuple((4 * j, 4, 0.5) for j in range(16)),
        lin_x=(np.ones((3, 64)), np.ones(3)), nx=64, nu=1,
        dtype=torch.float32, device="cpu")
    args = K._side_args(cons.lin_x, cons.cones_x, 64, "state")
    assert args[1] == 3 and args[4] == 16
    pairs = K.cone_pairs(cons.cones_x.starts, cons.cones_x.dims,
                         cons.cones_x.mus.device)
    assert pairs.shape == (16, 2) and pairs.dtype == torch.int32
    assert args[2] == pairs.data_ptr()
    with pytest.raises(ValueError, match="does not fit"):
        K._side_args(None, cons.cones_x, 60, "state")


# -- the warp layout (narrow maps) --------------------------------------------

@pytest.mark.parametrize("shape,takes", [
    ((4, 1, 20), True),     # the cartpole, sw 99
    ((4, 1, 25), True),     # sw 124
    ((4, 1, 26), False),    # sw 129: wider than the warp's 128 rows
    ((6, 3, 10), True),     # the rocket's box alone, sw 87
    ((12, 4, 8), True),     # sw 124
    ((12, 4, 9), False),    # sw 140
    ((12, 4, 20), False),   # the quadrotor, sw 316
], ids=["cartpole", "cartpole-n25", "cartpole-n26", "rocket-box",
        "quad-n8", "quad-n9", "quad-n20"])
def test_warp_plan(shape, takes):
    """An fp32 launch with box constraints only whose map has at most 128
    rows takes the warp layout: lane groups of 8 lanes, a warp each, as
    many warps a block (up to 16) as fit beside the resident map with
    their w2 (128 rows) and state, 8 rows x 4 lanes a thread in the
    product, one pass; reduced iterations and projections keep the tiles,
    and so do wider maps."""
    sw = (shape[2] - 1) * shape[1] + shape[2] * shape[0]
    for state_free in (True, False):
        plan = K.warp_tile_plan(*shape, state_free)
        assert (plan is not None) == takes
        chosen = K.fused_tile_plan(*shape, False, state_free)
        assert (chosen == plan) == takes
        if not takes:
            assert chosen.warps == 0
            continue
        # a lane's state and the carry it stages (2 sw floats)
        state = K.state_floats(*shape, state_free) + 2 * sw
        # the map, the bounds (lo and hi a row, whole 16-byte pieces), then
        # each warp's w2 (128 rows) and its 8 lanes' state
        fixed = 4 * (sw * 128 + -(-2 * sw // 4) * 4)
        per_warp = 4 * 8 * (128 + state)
        assert plan.warps == min(K.MAX_WARPS, (
            K.SMEM_PER_BLOCK - K.WARP_STATIC_BYTES - fixed) // per_warp)
        assert plan.warps >= K.MIN_WARPS
        assert plan.smem == fixed + plan.warps * per_warp
        assert plan.smem + K.WARP_STATIC_BYTES <= K.SMEM_PER_BLOCK
        assert (plan.tile, plan.threads, plan.rows, plan.passes, plan.rpt,
                plan.lanes) == (8, 32 * plan.warps, 128, 1, 8, 4)
        assert plan.resident and plan.state_shared and not plan.bulk_ring
        assert (plan.cluster, plan.w2_global) == (1, False)
        # reduced iterations (K1c) and projections (K1e) keep the tiles
        for kw in (dict(reduced=True), dict(projected=True)):
            other = K.fused_tile_plan(*shape, state_free=state_free, **kw)
            assert other.warps == 0 and other.tile == 32
    # the cartpole: 8 warps a block (255 registers a thread), state-free
    # or not; past WARP_MAX_GROUPS groups the tiles
    if shape == (4, 1, 20):
        assert K.warp_tile_plan(4, 1, 20).warps == 8
        assert K.warp_tile_plan(4, 1, 20, False).warps == 8
        assert K.fused_tile_plan(4, 1, 20, groups=1024).warps == 8
        assert K.fused_tile_plan(4, 1, 20, groups=1025).warps == 0


@pytest.mark.parametrize("per_group,warps,per_sm,expect", [
    (1024, 8, 1, (132, 8)),   # the MPC loop's 8,192 plants
    (512, 8, 1, (132, 4)),    # the mis-set cartpole's 4,096 slots a bucket
    (8192, 8, 1, (132, 8)),   # the headline's 65,536 lanes
    (512, 4, 2, (264, 2)),    # two blocks an SM
    (5, 8, 1, (5, 1)),        # fewer lane groups than SMs
], ids=["mpc-8192", "misset-4096", "headline-65536", "two-an-sm", "tiny"])
def test_warp_launch_shares_the_lane_groups_over_the_sms(per_group, warps,
                                                         per_sm, expect):
    """A warp-layout launch runs as many blocks a group as the card holds
    at once, no more than a group's lane groups, each of no more warps than
    the plan's and than a group's lane groups share out over its blocks."""
    plan = K.warp_tile_plan(4, 1, 20)._replace(warps=warps)
    assert K.launch_warps(plan, per_group, 132, per_sm) == expect


def test_queue_iterations_model():
    """The queue model: one warp runs every lane group in turn (and stages
    the map once); many warps end with the slowest lane group; a group's
    blocks start as block slots free; one group's lane groups spread over
    its blocks whichever group the live lanes lie in."""
    counts = torch.tensor([3, 9, 1, 1, 7, 2, 2, 5] * 2)
    assert K.queue_iterations(counts, 1, 1, 1, lanes=2) == \
        K.tile_iterations(counts, 2) + 1
    assert K.queue_iterations(counts, 1, 8, 1, lanes=2) == 9 + 1
    # two groups, a block of two warps each: group 0's lane groups (9, 1,
    # 7, 5) end at 1 + 13 (warp 0: 9; warp 1: 1, 7, 5, each ticket taken
    # as it frees), group 1's four of 1 iteration at 1 + 2 beside it, or
    # after it (1 + 13, then 1 + 2) where the card holds one block
    g = torch.tensor([3, 9, 1, 1, 7, 2, 2, 5, 1, 1, 1, 1, 1, 1, 1, 1])
    assert K.queue_iterations(g, 2, 1, 2, lanes=2) == 1 + 13
    assert K.queue_iterations(g, 2, 1, 2, slots=1, lanes=2) == 1 + 13 + 1 + 2
    # a bucketed launch: every live lane in one of five groups, the rest
    # pads (1 iteration); the slowest lane group sets the end
    live = torch.ones(5 * 64, dtype=torch.int32)
    live[128:192] = torch.arange(64) + 100
    assert K.queue_iterations(live, 5, 8, 2, lanes=8) == 1 + 163
    assert 1 + 163 <= K.queue_iterations(live, 5, 8, 2, slots=8,
                                         lanes=8) <= 1 + 163 + 6


def test_last_layout_keeps_the_maps_layout():
    """A solver's launch layout (``LastLayout``): the same maps give the
    same layout object; an in-place write to a map, other maps or a plan
    forced in the plan function's place make it anew, equal to a fresh
    ``launch_layout``."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    keep = K.LastLayout()
    args = (4, 1, 20, False, True, False, 1)
    first = keep(pm, *args)
    assert keep(pm, *args) is first
    assert first[0] == K.warp_tile_plan(4, 1, 20)
    pm.T12.mul_(2.0)
    again = keep(pm, *args)
    assert again is not first
    assert torch.equal(again[1][0], 2.0 * first[1][0])
    other = pm._replace(T1=pm.T1 + 1.0)
    assert torch.equal(keep(other, *args)[1][3], first[1][3] + 1.0)
    assert keep(other, 4, 1, 20, False, True, True, 1)[0].warps == 0
    tiles = K.shared_tile_plan(4, 1, 20)
    saved = K.fused_tile_plan
    K.fused_tile_plan = lambda *a, **k: tiles
    try:
        assert keep(other, *args)[0] == tiles
    finally:
        K.fused_tile_plan = saved
    assert keep(other, *args)[0] == first[0]
