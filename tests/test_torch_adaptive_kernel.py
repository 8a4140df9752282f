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
                               from_pass_major, grouped_cartpoles,
                               grouped_rockets, jax_arrays, rocket_setup,
                               rocket_x0, taylor_setup, x0_batch)

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
    """K1's tiles of 32 lanes on 256 threads for a batch that fills the
    card (the batch-aware plans: ``test_plan_takes_the_batch``).  The
    cartpole's maps (T1 3 x 24 x 128, the interleaved T2 stack 100 x 128,
    fp32) sit in shared memory beside the lanes' state; the quadrotor's
    (337 KB + 385 KB) stream through the slab ring, 20 rows a thread
    covering its 316 forward and 304 stacked backward rows in one pass, on
    the 4-lane layout (10 rows x 4 lanes a thread, 12 x 4 in the backward;
    the maps' rows padded to 320 and 312: the same bytes)."""
    cart = K2.adaptive_tile_plan(4, 1, 20, 2)
    # vec1 24 + ux 100 rows, flags, rho, partials, y/z/v 118 rows, maps
    assert cart == K2.AdaptivePlan(
        32, 256, 8, 1, 1, True, True, 32, 128,
        3072 + 12800 + 144 + 256 + 12288 + 15104 + 36864 + 51200)
    quad = K2.adaptive_tile_plan(12, 4, 20, 2)
    assert quad == K2.AdaptivePlan(
        32, 256, 20, 1, 1, False, True, 96, 320,
        11392 + 40576 + 144 + 256 + 12288 + 50176 + 6 * 8 * 320 * 4,
        ld=(320, 312), lanes=4)
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
    # passes of 320 rows (the backward's of 384 on the 4-lane layout, the
    # plan's at N = 40; at N = 57 the plan takes the cluster, and the
    # tiles of 32 on 2 lanes beside it run passes of 320)
    for N_, sw, su in ((40, 636, 156), (57, 908, 224)):
        wide = K2.adaptive_tile_plan(12, 4, N_, 2)
        if N_ == 57:
            assert wide.cluster > 1
            wide = K2.shared_adaptive_plan(12, 4, N_, 2)
        assert wide.passes1 * wide.width >= sw \
            > (wide.passes1 - 1) * wide.width
        assert wide.passes2 * wide.width2 >= 4 * su
        assert wide.passes1 > 1
    # in shared memory, tiles of 32 lanes while their iterates fit beside
    # the slab ring (sw 1,196 in fp32, N = 75; 860 with the bf16 maps and
    # operand, N = 54), then tiles of 16 (sw 1,436 at N = 90, and more),
    # then none; from K2_CLUSTER_FROM_WIDTH (sw 908, N = 57: where the
    # cluster beat the tiles of 32 on 2 lanes and the tiles of 16 on the
    # card) or past the last shared layout, a tile of 32 split over a
    # thread block cluster
    assert K2.shared_adaptive_plan(12, 4, 75, 2).tile == 32
    assert K2.K2_CLUSTER_FROM_WIDTH == 16 * 57 - 4
    assert K2.adaptive_tile_plan(12, 4, 75, 2) == K2.cluster_adaptive_plan(
        12, 4, 75, 2)
    assert K2.adaptive_tile_plan(12, 4, 54, 2, reduced=True).tile == 32
    for N_, reduced in ((76, False), (90, False), (133, False), (55, True),
                        (94, True)):
        p = K2.shared_adaptive_plan(12, 4, N_, 2, reduced)
        assert (p.tile, p.rpt, p.width) == (16, 8, 256)
        assert p.passes1 * p.width >= 16 * N_ - 4
        q = K2.adaptive_tile_plan(12, 4, N_, 2, reduced)
        assert q == (p if 16 * N_ - 4 < K2.K2_CLUSTER_FROM_WIDTH else
                     K2.cluster_adaptive_plan(12, 4, N_, 2, reduced))
    for N_, reduced in ((134, False), (95, True)):
        assert K2.shared_adaptive_plan(12, 4, N_, 2, reduced) is None
        p = K2.adaptive_tile_plan(12, 4, N_, 2, reduced)
        assert (p.tile, p.rpt, p.iterates_global) == (32, K2.K2_CLUSTER_RPT,
                                                      False)
        assert p.cluster > 1 and not p.resident and not p.state_shared
        assert p.ld1 >= 16 * N_ - 4 and p.ld2 >= 16 * (N_ - 1)
        assert p.smem <= K.SMEM_PER_BLOCK


@pytest.mark.parametrize("shape,tiles,sms,cont", [
    ((12, 4, 20), 64, 132, "cont"),   # the adaptive pipeline's 2,048 slots
    ((12, 4, 20), 66, 132, "cont"),   # tiles of 16 on all 132 SMs
    ((12, 4, 20), 67, 132, "four"),   # past the card: tiles of 32
    ((12, 4, 20), 512, 132, "four"),  # the bulk pass's 16,384 lanes
    ((12, 4, 20), 128, 132, "four"),  # the group grid's 8 x 512 lanes
    ((12, 4, 20), 64, 114, "four"),   # a card of 114 SMs
    ((12, 4, 32), 16, 132, "cont"),   # sw 508: one pass of 512 rows
    ((12, 4, 40), 16, 132, "four"),   # sw 636: 4 lanes in 2 + 2 passes
    ((4, 1, 20), 16, 132, "two"),     # the cartpole: its maps resident
    ((6, 3, 10), 16, 132, "two"),     # the rocket: its maps resident
    ((12, 4, 90), 16, 132, "two"),    # the cluster's widths
    ((12, 4, 20), 256, 132, "four"),  # one group of 8,192 lanes
    ((12, 4, 20), 72, 132, "four"),   # past the card, the 4-lane's win
    ((12, 4, 12), 64, 132, "cont"),   # sw 188: a narrow map streamed
    ((6, 3, 12), 64, 132, "cont"),    # sw 105: the narrowest streamed
], ids=["quad-2048", "quad-66", "quad-67", "quad-bulk", "quad-grid",
        "quad-114sms", "quad-n32", "quad-n40", "cartpole", "rocket",
        "quad-n90", "quad-256", "quad-72", "quad-n12", "rocket-n12"])
def test_plan_takes_the_batch(shape, tiles, sms, cont):
    """A launch whose tiles of 32 lanes would leave half the card's SMs idle
    (2 x tiles <= SMs) and stream their maps takes the continuation layout
    where its products take one pass ("cont"): tiles of 16 lanes, each
    product one pass of 512 rows (8 rows x 4 lanes a thread, slabs of 16
    k-rows), only the map's valid rows streamed, where its tiles of 32
    take 20 rows a thread, at any width (quad-n12: sw 188; rocket-n12: sw
    105); every other launch keeps the plan of a
    batch that fills the card, field for field: where its tiles of 32
    stream their maps at 20 rows a thread, the 4-lane layout ("four": 10
    rows x 4 lanes a thread in passes of 320 rows, 12 x 4 in the backward
    product in passes of 384, slabs of 16 k-rows by the bulk copy engine;
    quad-n40: 2 + 2 passes), else 2 lanes a thread or a cluster's 8
    ("two").  A plan for a batch needs the card's SMs."""
    full = K2.adaptive_tile_plan(*shape, 2)
    with pytest.raises(ValueError, match="SMs"):
        K2.adaptive_tile_plan(*shape, 2, tiles=tiles)
    for reduced in (False, True):
        for state_free in (True, False):
            p = K2.adaptive_tile_plan(*shape, 2, reduced, state_free,
                                      tiles=tiles, sms=sms)
            base = K2.adaptive_tile_plan(*shape, 2, reduced, state_free)
            if cont == "four":
                su, _, sw = K2._dims(*shape)
                assert p == base == K2.four_lane_adaptive_plan(
                    *shape, 2, reduced, state_free)
                assert (p.tile, p.rpt, p.width, p.width2) == (
                    32, K2.K2_LANES4_RPT, 320, 384)
                assert (p.passes1, p.passes2) == (-(-sw // 320),
                                                  -(-4 * su // 384))
                assert (p.lanes, p.slab_k, p.bulk_ring, p.resident) == (
                    4, 16, True, False)
                assert p.smem + K.RING_BARS_BYTES <= K.SMEM_PER_BLOCK
                continue
            if cont == "two":
                assert p == base and not p.bulk_ring
                assert K2.four_lane_adaptive_plan(*shape, 2, reduced,
                                                  state_free) is None
                continue
            assert p == K2.continuation_adaptive_plan(*shape, 2, reduced,
                                                      state_free)
            assert (p.tile, p.rpt, p.width, p.passes1, p.passes2) == (
                16, K2.K2_CONT_RPT, 512, 1, 1)
            assert (p.lanes, p.slab_k, p.cluster, p.resident) == (4, 16, 1,
                                                                  False)
            assert p.smem <= K.SMEM_PER_BLOCK
    if shape == (12, 4, 20):
        assert full.tile == 32 and (full.lanes, full.slab_k) == (4, 16)
        assert full == K2.four_lane_adaptive_plan(12, 4, 20, 2)
    # the maps' rows padded only to a multiple of a thread's 8 (sw 316,
    # 4 su 304), so that a slab is one bulk copy
    p = K2.continuation_adaptive_plan(12, 4, 20, 2)
    assert (p.ld1, p.ld2) == (320, 304) and p.bulk_ring


def _k2_layout_smem(nx, nu, N, order, tile, W, reduced, state_free, shared):
    """csrc/condensed_adaptive.cu k2_layout's total for a streamed plan of
    one block a tile, offset by offset: vec1, ux, the latch flags, rho
    twice, the partials, the duals and slacks where shared, the slab ring
    (the larger of the fp32 ring, kStages x kSlabK rows of W floats, and
    the bf16 one), the bf16 product input."""
    up16 = lambda n: -(-n // 16) * 16
    su, sx = (N - 1) * nu, N * nx
    sw, in1 = su + sx, su + nx + 1
    state = (2 * su + (1 if state_free else 2) * sx) if shared else 0
    kp = max(-(-in1 // 32) * 32, -(-(sw + 1) // 32) * 32)
    ring = max(4 * 6 * 8 * W, 2 * 4 * W * (16 + 8) if reduced else 0)
    return (up16(4 * in1 * tile) + up16(4 * (sw + 1) * tile)
            + up16(4 * (tile + 1)) + up16(8 * tile) + up16(48 * 256)
            + up16(4 * state * tile) + up16(ring)
            + (up16(2 * tile * (kp + 8)) if reduced else 0))


@pytest.mark.parametrize("shape", [(12, 4, 20), (4, 1, 52), (4, 1, 64),
                                   (6, 3, 27)],
                         ids=["quad-n20", "cart-n52", "cart-n64",
                              "rocket-n27"])
def test_four_lane_plan_pads_the_maps_to_the_threads_rows(shape):
    """The 4-lane layout's padded rows (``bulk_ld``) and shared memory
    against the kernel's arithmetic (csrc/condensed_adaptive.cu
    bulk_rows, K2Product, k2_layout): the forward map's sw rows padded to
    a multiple of a thread's 10 rows and of 4, the backward stack's 4 su
    to whole outputs of 4 rows (12 a thread) and of 4, both within the
    products' 320 rows, so that every thread's rows lie inside a slab's
    row and 3 slots of 16 k-rows of either map fit the ring of 6 x 8 rows
    of 320; the plan's bytes are the 2-lane plan's (the same ring), with
    room for the ring's barriers; a launch with a carry out stages its
    carry slacks after the layout where they fit (``launch_smem``).  At
    the quadrotor's N = 20, the
    cartpole's N = 52 and 64 and the rocket's N = 27 (the widest whose
    backward stack, 4 su = 312, takes one pass)."""
    nx, nu, N_ = shape
    su, sw = (N_ - 1) * nu, (N_ - 1) * nu + N_ * nx
    for reduced in (False, True):
        for state_free in (True, False):
            p = K2.four_lane_adaptive_plan(nx, nu, N_, 2, reduced,
                                           state_free)
            two = K2.shared_adaptive_plan(nx, nu, N_, 2, reduced,
                                          state_free)
            assert p == two._replace(lanes=4, ld=p.ld)
            ld1, ld2 = p.ld
            assert ld1 % 4 == 0 and ld2 % 4 == 0
            assert ld1 >= -(-sw // 10) * 10 > ld1 - 14
            assert ld2 >= -(-4 * su // 12) * 12 > ld2 - 16
            assert max(p.ld) <= p.width == 320
            assert 3 * 16 * max(p.ld) * 4 <= K.ring_bytes(p.width, False)
            assert (p.ld1, p.ld2) == K2.bulk_ld(su, sw, p.rpt)
            assert p.smem == _k2_layout_smem(nx, nu, N_, 2, 32, 320,
                                             reduced, state_free,
                                             p.state_shared)
            assert p.smem + K.RING_BARS_BYTES <= K.SMEM_PER_BLOCK
            # a launch with a carry out stages the tile's carry slacks (sw
            # rows x 32 lanes) after the layout where they fit, then the
            # constraint data; without a carry, or on 2 lanes, none
            cap = K.SMEM_PER_BLOCK - K.RING_BARS_BYTES
            stage = -(-4 * sw * 32 // 16) * 16
            smem, staged = K2.launch_smem(p, sw, True, 64)
            assert staged == (p.smem + stage <= cap)
            assert smem == p.smem + (stage if staged else 0) + (
                64 if p.smem + (stage if staged else 0) + 64 <= cap else 0)
            assert K2.launch_smem(p, sw, False, 64) == (p.smem + 64, False)
            assert not K2.launch_smem(two, sw, True)[1]
    # the quadrotor's fp32 state-free bulk pass stages its carry (176,272 +
    # 40,448 bytes); with the state dual or the bf16 maps there is no room
    quad = K2.four_lane_adaptive_plan(12, 4, 20, 2)
    assert K2.launch_smem(quad, 316, True) == (176272 + 40448, True)
    for reduced, free in ((False, False), (True, True)):
        q = K2.four_lane_adaptive_plan(12, 4, 20, 2, reduced, free)
        assert K2.launch_smem(q, 316, True) == (q.smem, False)
    assert K2.bulk_ld(76, 316, 20) == (320, 312)
    assert K2.bulk_ld(76, 316, 16) == (320, 304)  # the continuation's


MULTI_PASS_SHAPES = [(12, 4, 21), (12, 4, 30), (12, 4, 40), (20, 9, 20),
                     (6, 3, 40)]
MULTI_PASS_IDS = ["quad-n21", "quad-n30", "quad-n40", "chain", "rocket-n40"]


@pytest.mark.parametrize("shape", MULTI_PASS_SHAPES, ids=MULTI_PASS_IDS)
def test_multi_pass_plan_takes_four_lanes(shape):
    """Where K2's tiles of 32 lanes stream their maps in more than one pass
    (the quadrotor at N = 21, 30, 40, sw 332-636; the 20-state chain, sw
    571; the rocket at N = 40, sw 357), the plan takes the 4-lane layout,
    for fp32 and reduced iterations, state-free or not, at any batch that
    fills the card: 10 rows x 4 lanes a thread in passes of 320 rows in
    the forward product, 12 x 4 in passes of 384 in the backward (whole
    interleaved outputs), each map's passes laid out one after the other,
    every pass but the last as wide as the product's rows at once and the
    last padded only to a thread's rows and to 16 bytes
    (csrc/condensed_adaptive.cu pass_rows), the ring's slots as wide as the
    widest pass, the shared memory the kernel's layout (k2_layout) with
    room for the ring's barriers.  The 2-lane plan it replaces took passes
    of 320 rows in both products."""
    nx, nu, N_ = shape
    su, sw = (N_ - 1) * nu, (N_ - 1) * nu + N_ * nx
    for reduced in (False, True):
        for state_free in (True, False):
            p = K2.adaptive_tile_plan(*shape, 2, reduced, state_free)
            for tiles in (128, 512, 2048):
                assert p == K2.adaptive_tile_plan(*shape, 2, reduced,
                                                  state_free, tiles=tiles,
                                                  sms=132)
            assert p == K2.four_lane_adaptive_plan(*shape, 2, reduced,
                                                   state_free)
            assert (p.tile, p.rpt, p.lanes, p.cluster) == (32, 20, 4, 1)
            assert p.bulk_ring and not p.resident and not p.iterates_global
            assert (p.width, p.width2, p.slab_k) == (320, 384, 16)
            assert (p.passes1, p.passes2) == (-(-sw // 320),
                                              -(-4 * su // 384))
            assert max(p.passes1, p.passes2) > 1
            two = K2.shared_adaptive_plan(*shape, 2, reduced, state_free)
            assert (two.lanes, two.width, two.passes1, two.passes2) == (
                2, 320, -(-sw // 320), -(-4 * su // 320))
            # each map: its full passes, then the last's valid rows padded
            # to a multiple of a thread's rows (10; 12 in the backward) and
            # of 4, never past the pass's rows
            for ld, v, W, rows in ((p.ld1, sw, 320, 10),
                                   (p.ld2, 4 * su, 384, 12)):
                full = (-(-v // W) - 1) * W
                last = ld - full
                assert v - full <= last <= W and last % 4 == 0
                assert -(-(v - full) // rows) * rows <= last \
                    < -(-(v - full) // rows) * rows + 4
                assert ld == K2.pass_rows(v, rows, W)
            assert p.ld == K2.bulk_ld(su, sw, 20, 320)
            last2 = p.ld2 - (p.passes2 - 1) * 384
            assert p.ring_rows == (384 if p.passes2 > 1 else
                                   max(320, last2))
            assert p.smem == _k2_layout_smem(nx, nu, N_, 2, 32, p.ring_rows,
                                             reduced, state_free,
                                             p.state_shared)
            assert p.smem + K.RING_BARS_BYTES <= K.SMEM_PER_BLOCK
            # a carry out stages the tile's carry slacks where they fit
            cap = K.SMEM_PER_BLOCK - K.RING_BARS_BYTES
            stage = -(-4 * sw * 32 // 16) * 16
            assert K2.launch_smem(p, sw, True)[1] == (p.smem + stage <= cap)


def test_four_lane_plan_stops_where_the_ring_does_not_fit():
    """The 4-lane layout in passes holds the tile's vec1 and ux beside a
    ring of 3 slots of 16 k-rows of 384 rows: up to the quadrotor's N = 56
    in fp32 (sw 892; the widest it takes), not at N = 57 (sw 908), where
    the plan keeps 2 lanes a thread in passes of 320 rows; with reduced
    iterations (the bf16 operand beside them) up to N = 40 (sw 636); the
    quadrotor at N = 20 keeps its one pass.  From N = 57 the plan takes the
    cluster (K2_CLUSTER_FROM_WIDTH: it beat 2 lanes a thread there)."""
    p = K2.adaptive_tile_plan(12, 4, 56, 2)
    assert (p.lanes, p.passes1, p.passes2, p.ring_rows) == (4, 3, 3, 384)
    assert p.smem + K.RING_BARS_BYTES <= K.SMEM_PER_BLOCK
    assert K2.four_lane_adaptive_plan(12, 4, 57, 2) is None
    assert K2.shared_adaptive_plan(12, 4, 57, 2).lanes == 2
    for reduced in (False, True):
        q = K2.adaptive_tile_plan(12, 4, 57, 2, reduced)
        assert q == K2.cluster_adaptive_plan(12, 4, 57, 2, reduced)
        assert q.cluster > 1
    assert K2.four_lane_adaptive_plan(12, 4, 40, 2, True).lanes == 4
    assert K2.four_lane_adaptive_plan(12, 4, 41, 2, True) is None
    one = K2.adaptive_tile_plan(12, 4, 20, 2)
    assert (one.passes1, one.passes2, one.ring_rows) == (1, 1, 320)


@pytest.mark.parametrize("groups", [1, 3], ids=["shared", "grouped"])
@pytest.mark.parametrize("shape", MULTI_PASS_SHAPES[1:] + [(12, 4, 20)],
                         ids=MULTI_PASS_IDS[1:] + ["quad-n20"])
def test_map_layout_pass_major_round_trip(shape, groups):
    """A 4-lane plan's maps (``map_layout``) laid out pass by pass: each T1
    block's rows in passes of 320 and the interleaved T2 stack's in passes
    of 384, a pass's [k][row] block after the earlier ones', gathered back
    as the kernel reads them, return the T1 blocks and the stack (row 4 r
    + c the row r of block c, its sw + 1 read columns) bit for bit, and
    every padded entry is zero; the bf16 maps keep their row-major layout
    (rows in order, padded to ld1 / ld2 and kp1 / kp2).  With one pass
    (the quadrotor at N = 20) the layout is the one-pass [k][row] one
    (ld1 320, ld2 312).  A leading group axis is kept."""
    nx, nu, N_ = shape
    su, sw = (N_ - 1) * nu, (N_ - 1) * nu + N_ * nx
    in1, ord1 = su + nx + 1, 3
    lead = (groups,) if groups > 1 else ()
    g = torch.Generator().manual_seed(7)
    T1s = torch.randn(lead + (ord1, sw, in1), generator=g)
    T2s = torch.randn(lead + (4, su, 2 * sw + 1), generator=g)
    tm = C.CondensedTaylorMaps(T1s, T2s, torch.ones(lead))
    plan = K2.four_lane_adaptive_plan(nx, nu, N_, 2, True)
    t1t, t2t, t1a, t2a = K2.map_layout(tm, su, sw, plan, True)
    assert t1t.shape == lead + (ord1, in1 * plan.ld1)
    assert t2t.shape == lead + ((sw + 1) * plan.ld2,)
    back1 = from_pass_major(t1t.flatten(-2), ord1, in1, sw, 320, plan.ld1)
    assert torch.equal(back1, T1s.transpose(-1, -2))
    stack = torch.cat([T2s[..., :sw], T2s[..., -1:]], -1)  # (.., 4, su, sw+1)
    stack = stack.transpose(-3, -2).reshape(lead + (4 * su, sw + 1))
    back2 = from_pass_major(t2t, 1, sw + 1, 4 * su, 384, plan.ld2)[..., 0,
                                                                   :, :]
    assert torch.equal(back2, stack.transpose(-1, -2))
    for c in range(4):  # row 4 r + c of the stack: row r of block c
        assert torch.equal(back2[..., c::4].transpose(-1, -2),
                           torch.cat([T2s[..., c, :, :sw],
                                      T2s[..., c, :, -1:]], -1))
    if plan.passes1 == plan.passes2 == 1:
        assert (plan.ld1, plan.ld2) == (320, 312)
        assert torch.equal(t1t.unflatten(-1, (in1, 320))[..., :sw],
                           T1s.transpose(-1, -2))
    assert t1a.shape == lead + (ord1, plan.ld1, plan.kp1)
    assert t2a.shape == lead + (plan.ld2, plan.kp2)
    assert torch.equal(t1a[..., :sw, :in1], T1s.to(torch.bfloat16))
    assert not t1a[..., sw:, :].any() and not t1a[..., in1:].any()
    assert torch.equal(t2a[..., :4 * su, :sw + 1], stack.to(torch.bfloat16))
    assert not t2a[..., 4 * su:, :].any() and not t2a[..., sw + 1:].any()


def test_last_layout_keeps_the_maps_layout(monkeypatch):
    """K2's launch layout (``LastLayout``): a second launch on the same maps
    makes no new plan or layout (the same objects); the pipeline's two
    plans (the bulk launch's 4-lane layout, the continuation's tiles of
    16) each keep their own layout; an in-place write to a map or other
    maps make them anew, equal to a fresh ``map_layout``; a plan forced
    in the plan function's place is taken."""
    _, (_, _, pt) = taylor_setup(quadrotor, F32, rho=5.0, ub=0.5)
    keep = K2.LastLayout()
    args = (12, 4, N, 2, False, True)
    su, sw = pt.T2s.shape[-2], pt.T1s.shape[-2]
    bulk = dict(tiles=512, sms=132)
    plan, maps = keep(pt, *args, **bulk)
    assert plan == K2.four_lane_adaptive_plan(*args)
    again = keep(pt, *args, **bulk)
    assert again[0] is plan and again[1] is maps
    cplan, cmaps = keep(pt, *args, tiles=64, sms=132)
    assert cplan.tile == 16 and cmaps is not maps
    assert keep(pt, *args, tiles=64, sms=132)[1] is cmaps
    assert keep(pt, *args, **bulk)[1] is maps
    for a, b in zip(maps, K2.map_layout(pt, su, sw, plan, False)):
        assert (a is None and b is None) or torch.equal(a, b)
    pt.T1s.mul_(2.0)
    plan2, maps2 = keep(pt, *args, **bulk)
    assert maps2 is not maps and torch.equal(maps2[0], 2.0 * maps[0])
    assert torch.equal(maps2[1], maps[1])
    other = pt._replace(T2s=pt.T2s + 1.0)
    maps3 = keep(other, *args, **bulk)[1]
    assert maps3 is not maps2
    assert torch.equal(maps3[1], K2.map_layout(other, su, sw, plan,
                                               False)[1])
    two = K2.shared_adaptive_plan(*args)
    monkeypatch.setattr(K2, "adaptive_tile_plan", lambda *a, **k: two)
    forced, fmaps = keep(other, *args, **bulk)
    assert forced == two and fmaps[0].shape[-1] == two.ld1 == 320
    assert fmaps[1].shape[-1] == two.ld2 == 320


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


def test_osqp_controller_on_a_wide_stage_matches_jax_kernel():
    """The OSQP-form controller on the 20-state chain (stages of 20 and 9
    entries: the kernel once held 12 a stage in each thread's registers),
    N = 8, B = 64, 300 iterations, against the Pallas kernel in interpret
    mode: equal counts on the lanes both solved, rho within rtol 1e-4,
    states and controls within 1e-5."""
    from torch_port_common import chain_plant, chain_x0, plant_setup
    A, B = chain_plant()
    setup = plant_setup(A, B, np.ones(20), np.ones(9), 1.0, 8, F32, ub=1.0,
                        taylor=True)
    x0 = chain_x0(64, 13).astype(np.float32)
    j, p = _both(setup, x0, tile=32, horizon=8, max_iter=300,
                 controller="osqp", adaptive_rho_min=0.2,
                 adaptive_rho_max=5.0, relaxation_alpha=1.0)
    both = (np.asarray(j[3]) == 1) & (p[3].numpy() == 1)
    assert both.sum() >= 32
    np.testing.assert_array_equal(p[2].numpy()[both], np.asarray(j[2])[both])
    np.testing.assert_allclose(p[4].numpy()[both], np.asarray(j[4])[both],
                               rtol=1e-4)
    for a, b in zip(p[:2], j[:2]):
        np.testing.assert_allclose(a.numpy()[both], np.asarray(b)[both],
                                   atol=1e-5)
    assert bool((p[4] != 1.0).any())  # the controller moved rho
