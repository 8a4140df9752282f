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
    # resident map 99 x 128
    assert K.fused_tile_plan(4, 1, 20) == K.TilePlan(
        32, 256, True, True, 128, 128, 12672 + 144 + 4096 + 27776 + 50688)
    # quadrotor, sw = 316: 20 rows a thread (320 padded rows), the state
    # (708 floats a lane) resident, T12 streamed in 8-row slabs (a ring of
    # six 8 x 320 fp32 slabs)
    plan = K.fused_tile_plan(12, 4, 20)
    assert plan == K.TilePlan(32, 256, False, True, 320, 320,
                              40448 + 144 + 4096 + 90624 + 6 * 8 * 320 * 4)
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
    refused: the product in passes of 16 RPT rows, every layout within one
    block's shared memory, the state in global memory beside w2; reduced
    iterations at 908 take 8 passes of 128 rows (the bf16 ring and the
    rounded w2 then fit); the widest maps a tile leaves room for."""
    for N_, sw in ((40, 636), (57, 908)):
        for reduced in (False, True):
            for state_free in (True, False):
                plan = K.fused_tile_plan(12, 4, N_, reduced, state_free)
                assert plan.passes > 1 and not plan.state_shared
                assert plan.rows == plan.passes * K.TILE_ROW_GROUPS \
                    * plan.rpt
                assert plan.rows >= sw > plan.rows - plan.rows // plan.passes
                assert plan.smem <= K.SMEM_PER_BLOCK
                assert plan.kp >= sw and plan.kp % K.KP_ALIGN == 0
    assert K.fused_tile_plan(12, 4, 40).rpt == 20
    lo = K.fused_tile_plan(12, 4, 57, reduced=True)
    assert (lo.passes, lo.rpt) == (8, 8)
    K.fused_tile_plan(12, 4, 99)
    K.fused_tile_plan(12, 4, 66, reduced=True)
    with pytest.raises(ValueError, match="no room"):
        K.fused_tile_plan(12, 4, 100)
    with pytest.raises(ValueError, match="no room"):
        K.fused_tile_plan(12, 4, 67, reduced=True)


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
    with pytest.raises(ValueError, match="at most 12"):
        K._side_args(wide.lin_x, wide.cones_x, 16, "state")


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
                              + 2 * 32 * 328)
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
