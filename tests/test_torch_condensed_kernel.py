"""Kernel K1 of the port (ops/cuda/condensed_kernel.py): its plain PyTorch
version vs the JAX Pallas kernel (interpret mode off the TPU), vs the port's
condensed oracle, and the wrapper's dispatch on the CPU; with the box alone
and with the linear and cone projections (K1e).  The CUDA kernel itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
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

from torch_port_common import (INTERPRET, cartpole_setup, rocket_setup,
                               rocket_x0, x0_batch)

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
    (dict(bf16_head_iters=8, check_termination=4, max_iter=48),
     NotImplementedError),
    (dict(precision="default"), NotImplementedError),
    (dict(num_groups=2), NotImplementedError),
    (dict(check_termination=3, max_iter=100), ValueError),
], ids=["bf16-head", "precision", "groups", "ct"])
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
    assert K.fused_tile_plan(4, 1, 20) == (128, True)     # cartpole, sw=99
    assert K.fused_tile_plan(12, 4, 20) == (64, False)    # quadrotor, sw=316


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
