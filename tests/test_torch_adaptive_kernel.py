"""Kernel K2 of the port (ops/cuda/adaptive_kernel.py): its plain PyTorch
version against the JAX Pallas adaptive kernel (interpret mode off the TPU)
in float32, against the port's condensed oracle in float64, and the
wrapper's dispatch and checks on the CPU.  The bars against the Pallas
kernel are those of tests/test_pallas_fused.py: equal iteration counts on the
lanes both solved, rho within rtol 1e-4, controls within 1e-4.  The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tinympc_julia_tpu.models import cartpole, quadrotor
from tinympc_julia_tpu.ops.condensed import build_condensed_taylor
from tinympc_julia_tpu.ops.pallas.adaptive_kernel import (
    make_condensed_adaptive_fused_solver as jax_adaptive)
from tinympc_julia_tpu_torch import types as PT
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.ops.cuda import _build
from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import (CART_X_BOUND, CPU, INTERPRET, TORCH_DTYPE,
                               grouped_cartpoles, grouped_rockets,
                               jax_arrays, rocket_setup, rocket_x0,
                               taylor_setup, x0_batch)

F32 = jnp.float32
N = 20
CART = dict(model=cartpole, rho=1.0, ub=5.0)
CART_KW = dict(en_input_bound=True, en_state_bound=False,
               adaptive_rho_min=0.5, adaptive_rho_max=5.0)
CARRY = K2.AdaptiveFusedCarry._fields


def _plant_args(p, c):
    """The factory's positional problem and cache data, as numpy."""
    return tuple(np.asarray(a) for a in (p.A, p.B, p.Q, p.R, c.Pinf,
                                         c.dPinf_drho))


def _bounds(p):
    return (p.u_min, p.u_max, p.x_min, p.x_max)


def _both(setup, x0, *, tile, horizon=N, warm=None, **kw):
    """The JAX Pallas kernel (``tile`` lanes a tile) and the port's factory
    on the CPU (the plain version) on the same inputs; ``warm`` is the pair
    of carries of an earlier call."""
    (jp, jc, jt), (pp, pc, pt) = setup
    jf = jax_adaptive(*_plant_args(jp, jc), horizon, batch_tile=tile,
                      interpret=INTERPRET, **kw)
    pf = K2.make_condensed_adaptive_fused_solver(*_plant_args(jp, jc),
                                                 horizon, **kw)
    tdt = TORCH_DTYPE[jp.A.dtype.type]
    jw = () if warm is None else (warm[0],)
    pw = () if warm is None else (warm[1],)
    j = jf(jt, *_bounds(jp), jnp.asarray(x0, jp.A.dtype), *jw)
    p = pf(pt, *_bounds(pp), torch.as_tensor(x0, dtype=tdt), *pw)
    return j, p


def _assert_lanes(p, j, min_both, *, exact_counts=True, rho_rtol=1e-4):
    """On the lanes both sides solved: equal counts, rho within rtol 1e-4
    (``rho_rtol``), controls and states within 1e-4."""
    jok, pok = np.asarray(j[3]) == 1, p[3].numpy() == 1
    both = jok & pok
    assert both.sum() >= min_both
    same = p[2].numpy()[both] == np.asarray(j[2])[both]
    if exact_counts:
        assert same.all()
    else:
        assert same.mean() >= 0.95
    sel = np.flatnonzero(both)[same]
    np.testing.assert_allclose(p[4].numpy()[sel], np.asarray(j[4])[sel],
                               rtol=rho_rtol)
    np.testing.assert_allclose(p[1].numpy()[sel], np.asarray(j[1])[sel],
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(p[0].numpy()[sel], np.asarray(j[0])[sel],
                               atol=1e-4, rtol=1e-4)


def test_cold_osqp_matches_jax_kernel():
    """Cartpole, B = 128, Pallas tile 64, the OSQP-form controller with rho
    clipped to [0.5, 5], 200 iterations."""
    x0 = x0_batch(128, 0).astype(np.float32)
    j, p = _both(taylor_setup(dtype=F32, **CART), x0, tile=64, max_iter=200,
                 **CART_KW)
    _assert_lanes(p, j, 96)
    rho = p[4].numpy()
    assert rho.min() >= 0.5 and rho.max() <= 5.0 and (rho != 1.0).any()


def test_generic_state_dual_path_matches_jax_kernel():
    """With the cart position held to |x_0| <= 0.5 the bound binds and the
    state dual is live: the A^T g terms of the OSQP-form residuals enter
    the prediction."""
    x0 = (x0_batch(64, 1, scale=1.0) * np.array([0.45, 1.5, 0.4, 0.5])).astype(
        np.float32)
    setup = taylor_setup(dtype=F32, state_bound=CART_X_BOUND / 4, **CART)
    j, p = _both(setup, x0, tile=64, max_iter=200, carry_out=True,
                 **dict(CART_KW, en_state_bound=True))
    _assert_lanes(p, j, 40)
    assert float(p[5].g.abs().max()) > 0.0
    np.testing.assert_allclose(p[5].g.numpy(), np.asarray(j[5].g), atol=1e-3,
                               rtol=1e-4)


def test_warm_chain_matches_jax_kernel():
    """30 iterations with ``carry_out``, then 400 warm from the carry: both
    calls against the Pallas kernel's; the first call's carry within the
    fp32 reassociation bar of tests/test_pallas_fused.py."""
    x0 = x0_batch(128, 5).astype(np.float32)
    setup = taylor_setup(dtype=F32, **CART)
    j1, p1 = _both(setup, x0, tile=64, max_iter=30, carry_out=True,
                   **CART_KW)
    assert 0 < int(p1[3].sum()) < 128
    np.testing.assert_array_equal(p1[3].numpy(), np.asarray(j1[3]))
    np.testing.assert_array_equal(p1[2].numpy(), np.asarray(j1[2]))
    for k in CARRY:
        np.testing.assert_allclose(getattr(p1[5], k).numpy(),
                                   np.asarray(getattr(j1[5], k)), atol=2e-5,
                                   rtol=1e-4, err_msg=k)
    assert p1[5].rho.shape == (1, 128)
    j2, p2 = _both(setup, x0, tile=64, max_iter=400, warm_start=True,
                   warm=(j1[5], p1[5]), **CART_KW)
    _assert_lanes(p2, j2, 115, exact_counts=False)
    # the Pallas kernel's carry, carried across by the converter, continues
    # the same way
    warm = convert.carry_from_numpy(jax_arrays(j1[5]), dtype=torch.float32,
                                    device=CPU)
    assert isinstance(warm, K2.AdaptiveFusedCarry)
    _, p2b = _both(setup, x0, tile=64, max_iter=400, warm_start=True,
                   warm=(j1[5], warm), **CART_KW)
    _assert_lanes(p2b, j2, 115, exact_counts=False)


def test_check_termination_5_matches_jax_kernel():
    x0 = x0_batch(64, 6).astype(np.float32)
    j, p = _both(taylor_setup(dtype=F32, **CART), x0, tile=64, max_iter=400,
                 check_termination=5, **CART_KW)
    conv = p[3].numpy() == 1
    assert conv.mean() > 0.85
    assert (p[2].numpy()[conv] % 5 == 0).all()
    _assert_lanes(p, j, 54)


def test_taylor_order_4_matches_jax_kernel():
    """Taylor order 4 (five T1 blocks, Horner over four powers of drho):
    the plain version, which the kernel follows block by block from the
    highest order down, against the Pallas kernel's any-order body."""
    x0 = x0_batch(64, 7).astype(np.float32)
    setup = taylor_setup(dtype=F32, order=4, **CART)
    assert setup[1][2].T1s.shape[0] == 5
    j, p = _both(setup, x0, tile=64, max_iter=200, carry_out=True,
                 **CART_KW)
    _assert_lanes(p, j, 48)
    assert (p[4].numpy() != 1.0).any()


def test_reduced_precision_control_flow_matches_jax_kernel(monkeypatch):
    """``precision="default"`` at ct = 5 with the operand rounding switched
    off (off the TPU the Pallas kernel's DEFAULT precision is fp32 too): the
    reduced iterations' products are the tensor cores' k16 sums of the fp32
    operands, every iteration that checks ((i + 1) % 5 == 0) or predicts
    rho (i % 5 == 0) is fp32, and the lanes follow the Pallas kernel's."""
    monkeypatch.setattr(K2, "bf16_round", lambda t: t)
    x0 = x0_batch(64, 6).astype(np.float32)
    j, p = _both(taylor_setup(dtype=F32, **CART), x0, tile=64, max_iter=200,
                 check_termination=5, precision="default", **CART_KW)
    assert (p[2].numpy()[p[3].numpy() == 1] % 5 == 0).all()
    _assert_lanes(p, j, 48, exact_counts=False)


def test_reduced_precision_at_ct1_equals_full_precision():
    """At ct = 1 every iteration checks, so ``"default"`` runs every product
    in fp32 and equals ``"highest"`` bit for bit; at ct = 5 the rounding is
    real: the bf16 products move the iterates, and the plain version
    really rounds the maps and the operands to bf16."""
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F32, **CART)
    x0 = torch.as_tensor(x0_batch(32, 9), dtype=torch.float32)

    def run(**kw):
        return K2.make_condensed_adaptive_fused_solver(
            *_plant_args(pp, pc), N, max_iter=60, carry_out=True,
            **dict(CART_KW, **kw))(pt, *_bounds(pp), x0)

    full = run()
    same = run(precision="default")
    for a, b in zip(full[:5] + tuple(full[5]), same[:5] + tuple(same[5])):
        assert torch.equal(a, b)
    lo = run(check_termination=5, precision="default")
    hi = run(check_termination=5)
    assert not torch.equal(lo[1], hi[1])
    assert float((lo[1] - hi[1]).abs().max()) < 0.5


def test_termination_controller_with_trust_matches_jax_kernel():
    """The termination controller on a mis-set-low rho0 = 0.5 with the
    cart-position bound, trust 2: rho moves up to the trust clip and down
    through the deadband; the same rho on every lane."""
    x0 = (x0_batch(16, 5, scale=1.0) * np.array([1.8, 1.0, 0.4, 0.5])).astype(
        np.float32)
    setup = taylor_setup(dtype=F32, model=cartpole, rho=0.5, ub=5.0,
                         state_bound=CART_X_BOUND)
    j, p = _both(setup, x0, tile=16, max_iter=200, en_state_bound=True,
                 en_input_bound=True, controller="termination",
                 adaptive_rho_min=1e-4, adaptive_rho_max=1e4,
                 taylor_trust=2.0)
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(p[4].numpy(), np.asarray(j[4]), rtol=1e-4)
    rho = p[4].numpy()
    assert rho.max() == 2.5 and rho.min() < 0.5
    _assert_lanes(p, j, 8)


def _rocket_taylor(dtype):
    (jp, jc, _), (pp, pc, _) = rocket_setup(dtype)
    jt = build_condensed_taylor(jp, jc)
    pt = convert.taylor_maps_from_numpy(jax_arrays(jt),
                                        dtype=TORCH_DTYPE[dtype], device=CPU)
    return (jp, jc, jt), (pp, pc, pt)


ROCKET_KW = dict(abs_pri_tol=2e-3, abs_dua_tol=1e-3, en_state_bound=True,
                 en_input_bound=True, adaptive_rho_min=1.0,
                 adaptive_rho_max=100.0, soc_u=((0, 3, 0.25),),
                 soc_x=((0, 3, 0.5),))


@pytest.mark.parametrize("controller", ["osqp", "termination"])
def test_rocket_cones_match_jax_kernel(controller):
    """The rocket with its box and both cones, B = 64, 100 iterations: every
    lane solves with the Pallas kernel's count; the thrust cone holds."""
    x0 = rocket_x0(64).astype(np.float32)
    j, p = _both(_rocket_taylor(F32), x0, tile=64, horizon=10, max_iter=100,
                 controller=controller, **ROCKET_KW)
    assert int(p[3].sum()) == 64
    _assert_lanes(p, j, 64)
    uu = p[1].numpy()
    assert (np.linalg.norm(uu[..., :2], axis=-1)
            <= 0.25 * uu[..., 2] + 5e-3).all()


def test_carry_converts_to_the_fixed_kernel():
    """``w2 = [z - y; v - g]`` turns an adaptive carry into the fixed
    kernel's.  With rho pinned (min = max = rho0) the Taylor corrections
    vanish, so continuing on the fixed kernel's plain version equals
    continuing on the adaptive one's, lane for lane."""
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F32, **CART)
    maps = C.build_condensed(pp, pc)
    x0 = torch.as_tensor(x0_batch(16, 3), dtype=torch.float32)
    plant = _plant_args(pp, pc)
    kw = dict(en_input_bound=True, en_state_bound=False, adaptive_rho_min=1.0,
              adaptive_rho_max=1.0)
    mk = K2.make_condensed_adaptive_fused_solver
    *_, carry = mk(*plant, N, max_iter=20, carry_out=True, **kw)(
        pt, *_bounds(pp), x0)
    _, us_a, it_a, ok_a, _ = mk(*plant, N, max_iter=100, warm_start=True,
                                **kw)(pt, *_bounds(pp), x0, carry)
    warm = K.FusedCarry(torch.cat([carry.z - carry.y, carry.v - carry.g]),
                        carry.y, carry.g, carry.v, carry.z)
    _, us_f, it_f, ok_f = K.make_condensed_fused_solver(
        4, 1, N, max_iter=100, warm_start=True, en_input_bound=True,
        en_state_bound=False)(maps, pc.rho, *_bounds(pp), x0, warm)
    assert torch.equal(it_a, it_f) and torch.equal(ok_a, ok_f)
    both = ok_a == 1
    assert int(both.sum()) > 8
    np.testing.assert_allclose(us_a[both].numpy(), us_f[both].numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("case", ["osqp-state-bound-ct5-alpha",
                                  "termination-trust"])
def test_plain_version_matches_condensed_oracle(case):
    """f64: the plain version gives the per-lane counts, rho and controls of
    ``solve_condensed_adaptive`` on every lane, cold and warm."""
    if case.startswith("osqp"):
        setup = taylor_setup(dtype=jnp.float64, state_bound=CART_X_BOUND,
                             **CART)
        s = dict(en_state_bound=True, relaxation_alpha=1.5,
                 check_termination=5, adaptive_rho_min=0.5,
                 adaptive_rho_max=5.0)
        x0 = x0_batch(32, 7, scale=1.0)
    else:
        setup = taylor_setup(dtype=jnp.float64, model=quadrotor, rho=5.0,
                             ub=0.5)
        s = dict(en_state_bound=False, adaptive_rho_controller="termination",
                 adaptive_rho_taylor_trust=2.0, adaptive_rho_min=5.0,
                 adaptive_rho_max=1e3, abs_pri_tol=1e-4, abs_dua_tol=1e-2)
        x0 = x0_batch(32, 7, scale=0.3, nx=12)
    _, (pp, pc, pt) = setup
    x0 = torch.as_tensor(x0)
    kw = dict(abs_pri_tol=s.get("abs_pri_tol", 1e-3),
              abs_dua_tol=s.get("abs_dua_tol", 1e-3),
              en_state_bound=s["en_state_bound"], en_input_bound=True,
              relaxation_alpha=s.get("relaxation_alpha", 1.0),
              adaptive_rho_min=s["adaptive_rho_min"],
              adaptive_rho_max=s["adaptive_rho_max"],
              check_termination=s.get("check_termination", 1),
              controller=s.get("adaptive_rho_controller", "osqp"),
              taylor_trust=s.get("adaptive_rho_taylor_trust", float("inf")))
    warm_c = warm_k = None
    for max_iter in (30, 60):
        st = PT.Settings(adaptive_rho=True, en_input_bound=True,
                         max_iter=max_iter, **s)
        oc = C.solve_condensed_adaptive(pp, pc, st, x0, pt, warm=warm_c,
                                        return_carry=True)
        fn = K2.make_condensed_adaptive_fused_solver(
            *_plant_args(pp, pc), pp.N, max_iter=max_iter,
            warm_start=warm_k is not None, carry_out=True, **kw)
        ok = fn(pt, *_bounds(pp), x0, *(() if warm_k is None else (warm_k,)))
        assert torch.equal(ok[2], oc[2]) and torch.equal(ok[3], oc[3])
        np.testing.assert_allclose(ok[4].numpy(), oc[4].rho.numpy(),
                                   rtol=1e-9)
        np.testing.assert_allclose(ok[1].numpy(), oc[1].numpy(), atol=1e-9)
        for k in ("d", "y", "g", "v", "z"):
            np.testing.assert_allclose(getattr(ok[5], k).numpy(),
                                       getattr(oc[4], k).numpy(), atol=1e-9,
                                       err_msg=k)
        warm_c, warm_k = oc[4], ok[5]
    assert (ok[4] != float(pt.rho0)).any()


def test_cpu_solver_runs_the_plain_version_and_builds_nothing():
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F32, **CART)
    x0 = torch.as_tensor(x0_batch(16, 8), dtype=torch.float32)
    before = K2.condensed_adaptive_cuda.launches
    fn = K2.make_condensed_adaptive_fused_solver(
        *_plant_args(pp, pc), N, max_iter=20, **CART_KW)
    out = fn(pt, *_bounds(pp), x0)
    assert len(out) == 5 and out[4].shape == (16,)
    assert K2.condensed_adaptive_cuda.launches == before
    assert _build.load_library.cache_info().currsize == 0
    assert K2._kernel_fn.cache_info().currsize == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K2.condensed_adaptive_cuda(
            pt, *_bounds(pp), x0, None, plant=None, nx=4, nu=1, N=N,
            max_iter=5, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
            en_state_bound=False, en_input_bound=True, relaxation_alpha=1.0,
            adaptive_rho_min=0.5, adaptive_rho_max=5.0,
            adaptive_rho_clipping=True, check_termination=1,
            controller="termination", taylor_trust=2.0, warm_start=False,
            carry_out=False)
    assert _build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("kw,err", [
    (dict(num_groups=0), ValueError),
    (dict(precision="bf16"), ValueError),
    (dict(check_termination=4, max_iter=50), ValueError),
    (dict(max_iter=52), ValueError),
    (dict(check_termination=0), ValueError),
    (dict(controller="bogus"), ValueError),
], ids=["no-groups", "precision", "lcm", "multiple-of-5", "ct0", "controller"])
def test_unported_and_invalid_options_raise(kw, err):
    (_, _, _), (pp, pc, _) = taylor_setup(dtype=F32, **CART)
    with pytest.raises(err):
        K2.make_condensed_adaptive_fused_solver(*_plant_args(pp, pc), N,
                                                **kw)


def test_wrong_inputs_raise():
    (_, _, _), (pp, pc, pt) = taylor_setup(dtype=F32, **CART)
    fn = K2.make_condensed_adaptive_fused_solver(*_plant_args(pp, pc), N,
                                                 max_iter=5)
    with pytest.raises(ValueError, match="x0s"):
        fn(pt, *_bounds(pp), torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="warm"):
        fn(pt, *_bounds(pp), torch.zeros((8, 4)),
           K2.AdaptiveFusedCarry(*(torch.zeros(1) for _ in range(6))))
    with pytest.raises(ValueError, match="T1s"):
        fn(pt._replace(T1s=pt.T1s[:, :, :-1]), *_bounds(pp),
           torch.zeros((8, 4)))


def test_tile_plan():
    """K1's tiles of 32 lanes on 256 threads, whatever the batch.  The
    cartpole's maps (T1 3 x 24 x 128, the interleaved T2 stack 100 x 128,
    fp32) sit in shared memory beside the lanes' state; the quadrotor's
    (337 KB + 385 KB) stream through the slab ring, 20 rows a thread
    covering its 316 forward and 304 stacked backward rows in one pass."""
    cart = K2.adaptive_tile_plan(4, 1, 20, 2)
    # vec1 24 + ux 100 rows, flags, rho, partials, y/z/v 118 rows, maps
    assert cart == K2.AdaptivePlan(
        32, 256, 8, 1, 1, True, True, 32, 128,
        3072 + 12800 + 144 + 256 + 12288 + 15104 + 36864 + 51200)
    quad = K2.adaptive_tile_plan(12, 4, 20, 2)
    assert quad == K2.AdaptivePlan(
        32, 256, 20, 1, 1, False, True, 96, 320,
        11392 + 40576 + 144 + 256 + 12288 + 50176 + 6 * 8 * 320 * 4)
    assert quad.width == 320 and quad.ld1 >= 316 and quad.ld2 >= 4 * 76
    # reduced iterations add the bf16 maps (rows padded by 8) and the
    # rounded operand; every plan fits a block's shared memory
    lo = K2.adaptive_tile_plan(4, 1, 20, 2, reduced=True)
    assert lo.smem == cart.smem + 2 * 3 * 128 * 40 + 2 * 128 * 136 \
        + 2 * 32 * 136
    for shape in ((12, 4, 20), (12, 4, 40), (12, 4, 54), (6, 3, 10)):
        for reduced in (False, True):
            for state_free in (True, False):
                for order in (2, 4):
                    p = K2.adaptive_tile_plan(*shape, order, reduced,
                                              state_free)
                    assert p.smem <= K.SMEM_PER_BLOCK
    # the quadrotor at N = 40 and 57 (sw = 636, 908): the products in
    # passes of 320 rows
    for N_, sw, su in ((40, 636, 156), (57, 908, 224)):
        wide = K2.adaptive_tile_plan(12, 4, N_, 2)
        assert wide.passes1 * wide.width >= sw \
            > (wide.passes1 - 1) * wide.width
        assert wide.passes2 * wide.width >= 4 * su
        assert wide.passes1 > 1
    # tiles of 32 lanes while their iterates fit beside the slab ring (sw
    # 1,196 in fp32, N = 75; 860 with the bf16 maps and operand, N = 54),
    # then tiles of 16 (every width the one-thread-a-lane kernel took, sw
    # 1,436 at N = 90, and more), then no room
    assert K2.adaptive_tile_plan(12, 4, 75, 2).tile == 32
    assert K2.adaptive_tile_plan(12, 4, 54, 2, reduced=True).tile == 32
    for N_, reduced in ((76, False), (90, False), (133, False), (55, True),
                        (94, True)):
        p = K2.adaptive_tile_plan(12, 4, N_, 2, reduced)
        assert (p.tile, p.rpt, p.width) == (16, 8, 256)
        assert p.passes1 * p.width >= 16 * N_ - 4
    with pytest.raises(ValueError, match="no room"):
        K2.adaptive_tile_plan(12, 4, 134, 2)
    with pytest.raises(ValueError, match="no room"):
        K2.adaptive_tile_plan(12, 4, 95, 2, reduced=True)


# -- the group grid ----------------------------------------------------------

NG = 8  # horizon of the grouped cases


def _grouped_both(groups, x0, *, horizon, constraints=None, **kw):
    """The Pallas kernel on its (G, tiles) grid and the port's factory on
    the CPU, both from the G-stacked problems: maps, rho0, bounds and plant
    data per group."""
    (jps, jcs), (pps, pcs) = groups
    G, L = x0.shape[:2]
    jt = build_condensed_taylor(jps, jcs)
    pt = convert.taylor_maps_from_numpy(jax_arrays(jt), dtype=torch.float32,
                                        device=CPU)
    jkw = dict(kw)
    pkw = dict(kw)
    if constraints is not None:
        jkw.update(constraints[0])
        pkw.update(constraints[1])
    j = jax_adaptive(*_plant_args(jps, jcs), horizon, batch_tile=L,
                     num_groups=G, interpret=INTERPRET, **jkw)(
        jt, *_bounds(jps), jnp.asarray(x0, F32))
    p = K2.make_condensed_adaptive_fused_solver(
        pps.A, pps.B, pps.Q, pps.R, pcs.Pinf, pcs.dPinf_drho, horizon,
        num_groups=G, **pkw)(pt, *_bounds(pps),
                             torch.as_tensor(x0, dtype=torch.float32))
    return j, p


@pytest.mark.parametrize("controller,state_bound", [
    ("osqp", False), ("osqp", True), ("termination", False)])
def test_grouped_reference_matches_jax_kernel(controller, state_bound):
    """G = 3 randomised cartpoles (own rho0, plant, costs and bounds each) x
    L = 16 lanes, 100 iterations with the carry: lane for lane against the
    Pallas kernel, per-lane rho included."""
    G, L = 3, 16
    groups = grouped_cartpoles(G, F32, N=NG, state_bound=state_bound)
    x0 = np.random.default_rng(61).uniform(-0.5, 0.5, size=(G, L, 4))
    kw = dict(max_iter=200, en_input_bound=True, en_state_bound=state_bound,
              adaptive_rho_min=0.3, adaptive_rho_max=8.0,
              controller=controller, carry_out=True)
    if controller == "termination":
        kw["taylor_trust"] = 0.5
    j, p = _grouped_both(groups, x0.astype(np.float32), horizon=NG, **kw)
    # the OSQP-form controller drives rho down on this plant and solves
    # about a third of the lanes within the budget
    _assert_lanes(p, j, G * L // 4, exact_counts=False)
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(j[3]))
    assert p[4].shape == (G * L,) and p[5].rho.shape == (1, G * L)
    rho0 = groups[1][1].rho.repeat_interleave(L)
    assert bool((p[4] != rho0).any())  # some lane moved its rho
    if controller == "termination":  # the clip is around each group's rho0
        assert float((p[4] - rho0).abs().max()) <= 0.5 + 1e-6


def test_grouped_rocket_per_group_cones_match_jax_kernel():
    G, L = 2, 8
    groups = grouped_rockets(G, F32)
    (jps, _), (pps, _) = groups
    x0 = rocket_x0(G * L, seed=6).reshape(G, L, 6).astype(np.float32)
    jcons = dict(soc_u=((0, 3, np.asarray(jps.cones_u.mus)[:, 0]),),
                 soc_x=((0, 3, np.asarray(jps.cones_x.mus)[:, 0]),))
    pcons = K.problem_constraint_kw(
        pps, PT.Settings(en_input_soc=True, en_state_soc=True))
    j, p = _grouped_both(
        groups, x0, horizon=10, constraints=(jcons, pcons), max_iter=100,
        abs_pri_tol=2e-3, abs_dua_tol=1e-3, en_input_bound=True,
        en_state_bound=True, adaptive_rho_min=1.0, adaptive_rho_max=100.0,
        controller="termination")
    # a lane that moved its rho to 5.1 carries 1.3e-4 of fp32 noise in it
    _assert_lanes(p, j, G * L // 2, exact_counts=False, rho_rtol=1e-3)


def test_grouped_reference_equals_per_group_solves():
    """float64: each group of a grouped solve equals the shared-problem
    solve of that group alone."""
    G, L = 3, 6
    _, (pps, pcs) = grouped_cartpoles(G, jnp.float64, N=NG)
    pt = C.build_condensed_taylor(pps, pcs)
    x0 = torch.as_tensor(np.random.default_rng(67).uniform(
        -0.5, 0.5, size=(G, L, 4)))
    kw = dict(nx=4, nu=1, N=NG, max_iter=60, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.0, adaptive_rho_min=0.3,
              adaptive_rho_max=8.0, adaptive_rho_clipping=True,
              check_termination=1, controller="osqp",
              taylor_trust=float("inf"), warm_start=False, carry_out=True)
    plant = K2.AdaptivePlant(pps.A, pps.B, pps.Q, pps.R, pcs.Pinf,
                             pcs.dPinf_drho)
    joint = K2.condensed_adaptive_reference(pt, *_bounds(pps), x0, None,
                                            plant=plant, num_groups=G, **kw)
    for g in range(G):
        one = K2.condensed_adaptive_reference(
            C.CondensedTaylorMaps(*(m[g] for m in pt)),
            *(b[g] for b in _bounds(pps)), x0[g], None,
            plant=K2.AdaptivePlant(*(t[g] for t in plant)), **kw)
        lanes = slice(g * L, (g + 1) * L)
        assert torch.equal(joint[2][lanes], one[2])
        torch.testing.assert_close(joint[4][lanes], one[4], atol=1e-12,
                                   rtol=0)
        torch.testing.assert_close(joint[1][lanes], one[1], atol=1e-12,
                                   rtol=0)
        torch.testing.assert_close(joint[5].d[:, lanes], one[5].d,
                                   atol=1e-12, rtol=0)


def test_grouped_reduced_precision_equals_per_group_solves():
    """float32, ``precision="default"`` at ct = 5: the reduced products of a
    grouped solve (the tensor cores' k16 sums over G-stacked maps) give each
    group the bits of that group's solve alone."""
    G, L = 2, 8
    _, (pps, pcs) = grouped_cartpoles(G, jnp.float32, N=NG)
    pt = C.build_condensed_taylor(pps, pcs)
    x0 = torch.as_tensor(np.random.default_rng(68).uniform(
        -0.5, 0.5, size=(G, L, 4)), dtype=torch.float32)
    kw = dict(nx=4, nu=1, N=NG, max_iter=40, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              relaxation_alpha=1.0, adaptive_rho_min=0.3,
              adaptive_rho_max=8.0, adaptive_rho_clipping=True,
              check_termination=5, controller="termination",
              taylor_trust=2.0, warm_start=False, carry_out=True,
              precision="default")
    joint = K2.condensed_adaptive_reference(pt, *_bounds(pps), x0, None,
                                            plant=None, num_groups=G, **kw)
    for g in range(G):
        one = K2.condensed_adaptive_reference(
            C.CondensedTaylorMaps(*(m[g] for m in pt)),
            *(b[g] for b in _bounds(pps)), x0[g], None, plant=None, **kw)
        lanes = slice(g * L, (g + 1) * L)
        for a, b in ((joint[1][lanes], one[1]), (joint[4][lanes], one[4]),
                     (joint[5].d[:, lanes], one[5].d)):
            assert torch.equal(a, b)


def test_grouped_inputs_are_checked():
    _, (pps, pcs) = grouped_cartpoles(2, F32, N=NG)
    pt = C.build_condensed_taylor(pps, pcs)
    make = lambda G, **kw: K2.make_condensed_adaptive_fused_solver(
        pps.A, pps.B, pps.Q, pps.R, pcs.Pinf, pcs.dPinf_drho, NG,
        max_iter=5, num_groups=G, **kw)
    with pytest.raises(ValueError, match="T1s"):
        make(3)(pt, *_bounds(pps), torch.zeros((3, 4, 4)))
    with pytest.raises(ValueError, match="grouped x0s"):
        make(2)(pt, *_bounds(pps), torch.zeros((3, 4, 4)))
    shared = C.CondensedTaylorMaps(*(m[0] for m in pt))
    with pytest.raises(ValueError, match="plant"):
        make(3)(shared, *(b[0] for b in _bounds(pps)), torch.zeros((3, 4, 4)))
