"""Kernels K1 (with and without its linear and cone projections, K1e) and
K2 (per-lane adaptive rho) on the card: each CUDA kernel vs its plain
PyTorch version, the port's main paths through them, and the
single-instance solve() on the card.  Every test here
is marked ``cuda`` and skips where CUDA is not available.  The file imports
no JAX, so it also runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tinympc_julia_tpu_torch import TinyMPCSolver, make_problem
from tinympc_julia_tpu_torch.models import cartpole, quadrotor, rocket
from tinympc_julia_tpu_torch.ops.condensed import (build_condensed,
                                                   build_condensed_taylor)
from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
from tinympc_julia_tpu_torch.parallel import (three_phase_solve,
                                              two_phase_adaptive_solve)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

N = 20


@pytest.fixture
def dev():
    """The first CUDA device; skips where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _plant(model, ub, dev, x_bound=None):
    kw = {}
    if x_bound is not None:
        xb = np.tile(x_bound, (N, 1))
        kw = dict(x_min=-xb, x_max=xb)
    p = make_problem(model.A, model.B, np.diag(model.Q_DIAG),
                     np.diag(model.R_DIAG), model.RHO, N, u_min=-ub,
                     u_max=ub, dtype=torch.float32, device=dev, **kw)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    return p, c, build_condensed(p, c)


def _x0(B, nx, seed, scale, dev):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -scale, scale, size=(B, nx)), dtype=torch.float32, device=dev)


def _kw(nx, nu, **kw):
    base = dict(nx=nx, nu=nu, N=N, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                en_input_bound=True, warm_start=False, carry_out=True,
                relaxation_alpha=1.7, check_termination=1,
                en_state_bound=False, max_iter=400)
    base.update(kw)
    return base


def _agree(k, r):
    """>= 99% equal per-lane counts; 1e-4 on lanes with equal counts that
    both solved (fp32 sums in another order move only lanes that sit on the
    tolerance)."""
    same = k[2] == r[2]
    assert same.float().mean().item() >= 0.99
    both = same & (k[3] == 1) & (r[3] == 1)
    assert int(both.sum()) > k[2].numel() // 2
    assert (k[1] - r[1]).abs()[both].max().item() <= 1e-4
    assert (k[0] - r[0]).abs()[both].max().item() <= 1e-4


@pytest.mark.parametrize("model,nx,nu,ub,kw", [
    (cartpole, 4, 1, 5.0, {}),
    (cartpole, 4, 1, 5.0, dict(check_termination=4)),
    (cartpole, 4, 1, 5.0, dict(en_state_bound=True)),
    (quadrotor, 12, 4, 0.5, dict(check_termination=4, max_iter=1000)),
], ids=["ct1", "ct4", "state-bounded", "quadrotor"])
def test_kernel_matches_plain_version(dev, model, nx, nu, ub, kw):
    x_bound = np.array([2.0, 1e17, 1e17, 1e17]) \
        if kw.get("en_state_bound") else None
    p, c, m = _plant(model, ub, dev, x_bound)
    x0 = _x0(1000, nx, 0, 0.5 if nx == 4 else 0.3, dev)  # ragged last tile
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0, None)
    before = K.condensed_fused_cuda.launches
    k = K.condensed_fused_cuda(*args, **_kw(nx, nu, **kw))
    r = K.condensed_fused_reference(*args, **_kw(nx, nu, **kw))
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.launches == before + 1
    _agree(k, r)
    same = k[2] == r[2]
    for a, b in zip(k[4], r[4]):
        assert (a - b)[:, same].abs().max().item() <= 1e-3


def test_kernel_warm_chain_is_bit_exact(dev):
    p, c, m = _plant(cartpole, 5.0, dev)
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
            _x0(2048, 4, 1, 0.5, dev))
    one = K.condensed_fused_cuda(*args, **_kw(4, 1, max_iter=80,
                                              carry_out=False))
    a = K.condensed_fused_cuda(*args, **_kw(4, 1, max_iter=30))
    b = K.condensed_fused_cuda(*args, a[4], **_kw(
        4, 1, max_iter=50, warm_start=True, carry_out=False))
    done = a[3] == 1
    assert torch.equal(torch.where(done, a[2], 30 + b[2]), one[2])
    assert torch.equal(torch.where(done[:, None, None], a[1], b[1]), one[1])
    assert torch.equal(torch.where(done[:, None, None], a[0], b[0]), one[0])


def test_kernel_refuses_what_it_does_not_take(dev):
    p, c, m = _plant(cartpole, 5.0, dev)
    x0 = _x0(64, 4, 2, 0.5, dev)
    args = (m, 1.0, p.u_min, p.u_max, p.x_min, p.x_max)
    with pytest.raises(TypeError, match="float32"):
        K.condensed_fused_cuda(*args, x0.double(), None, **_kw(4, 1))
    with pytest.raises(ValueError, match="contiguous"):
        K.condensed_fused_cuda(*args, x0.T.contiguous().T, None,
                               **_kw(4, 1))


def test_api_and_pipeline_run_through_the_kernel(dev):
    s = TinyMPCSolver(dtype=torch.float32, device=dev)
    s.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
            np.diag(cartpole.R_DIAG), cartpole.RHO, 4, 1, N)
    s.set_bound_constraints(np.full((4, N), -1e17), np.full((4, N), 1e17),
                            np.full((1, N - 1), -5.0),
                            np.full((1, N - 1), 5.0))
    s.update_settings(relaxation_alpha=1.7, check_termination=4,
                      max_iter=400)
    x0 = _x0(3000, 4, 3, 0.5, dev)
    before = K.condensed_fused_cuda.launches
    xs, us, it, ok = s.solve_batch(x0, method="fused")
    assert K.condensed_fused_cuda.launches == before + 1
    assert xs.is_cuda and us.shape == (3000, N - 1, 1)
    assert int(ok.sum()) >= 0.99 * 3000
    p, c, m = _plant(cartpole, 5.0, dev)
    res = three_phase_solve(m, float(c.rho), p.u_min, p.u_max, p.x_min,
                            p.x_max, x0, nx=4, nu=1, N=N,
                            straggler_slots=512)
    assert K.condensed_fused_cuda.launches == before + 4
    assert int(res.converged()) >= 0.99 * 3000


def _rocket(dev, **settings):
    s = rocket.make_solver(dtype=torch.float32, device=dev, **settings)
    Xref, Uref = rocket.reference_trajectory(0)
    s.set_x_ref(Xref)
    s.set_u_ref(Uref)
    return s


def _rocket_x0(B, dev, lateral=1.0):
    x0 = rocket.X_INIT[None, :] * np.random.default_rng(2).uniform(
        0.9, 1.1, size=(B, 1))
    x0[:, :2] *= lateral
    return torch.as_tensor(x0, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("case", ["rocket", "rocket-no-state-box",
                                  "cartpole-halfspaces"])
def test_projections_match_plain_version(dev, case):
    """K1e: the rocket's cones (with and without the state box) and the
    cartpole's state halfspaces, kernel vs plain on 1000 lanes."""
    if case.startswith("rocket"):
        s = _rocket(dev)
        p, c = s.problem, s.cache
        m = build_condensed(p, c)
        cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                                   nx=6, nu=3, dtype=torch.float32,
                                   device=dev)
        x0 = _rocket_x0(1000, dev, 1.5 if case.endswith("box") else 1.0)
        kw = _kw(6, 3, N=rocket.HORIZON, abs_pri_tol=2e-3,
                 relaxation_alpha=1.0, max_iter=200,
                 en_state_bound=not case.endswith("box"), constraints=cons)
    else:
        p, c, m = _plant(cartpole, 5.0, dev)
        cons = K.fused_constraints(
            lin_x=(np.array([[1.0, 1, 0, 0], [0, 0, 1, 0.5]]),
                   np.array([1.0, 0.8])), nx=4, nu=1, dtype=torch.float32,
            device=dev)
        x0 = _x0(1000, 4, 4, 0.5, dev)
        kw = _kw(4, 1, relaxation_alpha=1.0, max_iter=150, constraints=cons)
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0, None)
    before = K.condensed_fused_cuda.projected_launches
    k = K.condensed_fused_cuda(*args, **kw)
    r = K.condensed_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.projected_launches == before + 1
    _agree(k, r)
    same = k[2] == r[2]
    for a, b in zip(k[4], r[4]):
        assert (a - b)[:, same].abs().max().item() <= 1e-3


def test_rocket_warm_chain_is_bit_exact(dev):
    s = _rocket(dev)
    p, c = s.problem, s.cache
    m = build_condensed(p, c)
    cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                               nx=6, nu=3, dtype=torch.float32, device=dev)
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
            _rocket_x0(2048, dev))
    kw = dict(nx=6, nu=3, N=rocket.HORIZON, abs_pri_tol=2e-3,
              abs_dua_tol=1e-3, en_state_bound=True, en_input_bound=True,
              relaxation_alpha=1.0, check_termination=1, constraints=cons)
    one = K.condensed_fused_cuda(*args, max_iter=72, warm_start=False,
                                 carry_out=False, **kw)
    a = K.condensed_fused_cuda(*args, max_iter=24, warm_start=False,
                               carry_out=True, **kw)
    b = K.condensed_fused_cuda(*args, a[4], max_iter=48, warm_start=True,
                               carry_out=False, **kw)
    done = a[3] == 1
    assert torch.equal(torch.where(done, a[2], 24 + b[2]), one[2])
    assert torch.equal(torch.where(done[:, None, None], a[1], b[1]), one[1])
    assert torch.equal(torch.where(done[:, None, None], a[0], b[0]), one[0])


def test_rocket_api_runs_the_projections(dev):
    s = _rocket(dev, max_iter=72)
    before = K.condensed_fused_cuda.projected_launches
    xs, us, it, ok = s.solve_batch(_rocket_x0(3000, dev), method="fused")
    assert K.condensed_fused_cuda.projected_launches == before + 1
    assert us.is_cuda and int(ok.sum()) >= 0.99 * 3000
    u = us[ok == 1]
    assert (torch.linalg.vector_norm(u[..., :2], dim=-1)
            <= rocket.MU_INPUT * u[..., 2] + 5e-3).all()


def test_single_instance_solve_on_the_card(dev):
    """float64 solve() on the card equals the CPU's: 5 closed-loop rocket
    steps, the same iteration counts and controls within 1e-9."""
    card, cpu = (rocket.make_solver(dtype=torch.float64, device=d)
                 for d in (dev, "cpu"))
    x = rocket.X_INIT * 1.1
    for k in range(5):
        Xref, Uref = rocket.reference_trajectory(k)
        for s in (card, cpu):
            s.set_x0(x)
            s.set_x_ref(Xref)
            s.set_u_ref(Uref)
            s.solve()
        assert card.state.x.is_cuda
        assert int(card.solution.iter) == int(cpu.solution.iter)
        u_card = card.get_solution().controls[:, 0]
        u_cpu = cpu.get_solution().controls[:, 0]
        np.testing.assert_allclose(u_card, u_cpu, atol=1e-9)
        x = rocket.simulate(x, u_cpu)


# -- kernel K2: per-lane adaptive rho ---------------------------------------

def _k2_kw(p, c, **kw):
    base = dict(plant=K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf,
                                       c.dPinf_drho),
                nx=p.nx, nu=p.nu, N=p.N, max_iter=200, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                relaxation_alpha=1.0, adaptive_rho_min=0.5,
                adaptive_rho_max=5.0, adaptive_rho_clipping=True,
                check_termination=1, controller="osqp",
                taylor_trust=float("inf"), warm_start=False, carry_out=True)
    base.update(kw)
    return base


def _k2_agree(k, r):
    """>= 99% equal per-lane counts; on those lanes x and u within 1e-4,
    the carry within 1e-4 of the larger of 1 and the entry's magnitude (the
    duals are not of order 1), and rho within rtol 1e-4."""
    same = (k[2] == r[2]) & (k[3] == r[3])
    assert same.float().mean().item() >= 0.99
    for j in (0, 1):
        assert (k[j] - r[j])[same].abs().max().item() <= 1e-4
    assert ((k[4] - r[4]).abs() / r[4])[same].max().item() <= 1e-4
    for a, b in zip(k[5][:5], r[5][:5]):
        rel = (a - b).abs() / b.abs().clamp(min=1.0)
        assert rel[:, same].max().item() <= 1e-4


_QUAD_KW = dict(controller="termination", taylor_trust=2.0,
                adaptive_rho_min=5.0, adaptive_rho_max=1e3)


@pytest.mark.parametrize("case", ["cartpole-osqp", "cartpole-ct5-relaxed",
                                  "cartpole-state-bounded",
                                  "rocket-termination",
                                  "quadrotor-termination"])
def test_adaptive_kernel_matches_plain_version(dev, case):
    """K2 vs plain on 1000 lanes (a ragged last tile): both controllers,
    the generic state-dual path, the cones, and the quadrotor shape whose
    maps stay in global memory."""
    kw, cons = {}, None
    if case.startswith("cartpole"):
        bounded = case.endswith("bounded")
        p, c, _ = _plant(cartpole, 5.0, dev, np.array(
            [0.5, 1e17, 1e17, 1e17]) if bounded else None)
        x0 = _x0(1000, 4, 0, 0.5, dev)
        if bounded:
            x0 = x0 * torch.tensor([0.9, 3.0, 0.8, 1.0], device=dev)
            kw = dict(en_state_bound=True)
        elif "ct5" in case:
            kw = dict(check_termination=5, relaxation_alpha=1.5)
    elif case.startswith("rocket"):
        s = _rocket(dev)
        p, c = s.problem, s.cache
        cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                                   nx=6, nu=3, dtype=torch.float32,
                                   device=dev)
        x0 = _rocket_x0(1000, dev)
        kw = dict(controller="termination", en_state_bound=True,
                  abs_pri_tol=2e-3, adaptive_rho_min=1.0,
                  adaptive_rho_max=100.0, max_iter=100, constraints=cons)
    else:
        p, c, _ = _plant(quadrotor, 0.5, dev)
        x0 = _x0(1000, 12, 1, 0.3, dev)
        kw = dict(max_iter=300, **_QUAD_KW)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, x0, None)
    before = K2.condensed_adaptive_cuda.launches
    k = K2.condensed_adaptive_cuda(*args, **_k2_kw(p, c, **kw))
    r = K2.condensed_adaptive_reference(*args, **_k2_kw(p, c, **kw))
    torch.cuda.synchronize()
    assert K2.condensed_adaptive_cuda.launches == before + 1
    assert int(k[3].sum()) > 500
    _k2_agree(k, r)
    if case.endswith("bounded"):
        assert float(k[5].g.abs().max()) > 0.0


def test_adaptive_warm_chain_matches_plain_chain(dev):
    """30 iterations with the carry, then 50 warm: each call against the
    plain version's (the continuation restarts the rho-update counter, so
    the chain is not the 80-iteration solve)."""
    p, c, _ = _plant(cartpole, 5.0, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(2048, 4, 1, 0.5, dev))
    k1 = K2.condensed_adaptive_cuda(*args, None, **_k2_kw(p, c, max_iter=30))
    r1 = K2.condensed_adaptive_reference(*args, None,
                                         **_k2_kw(p, c, max_iter=30))
    _k2_agree(k1, r1)
    kw = _k2_kw(p, c, max_iter=50, warm_start=True)
    k2 = K2.condensed_adaptive_cuda(*args, k1[5], **kw)
    r2 = K2.condensed_adaptive_reference(*args, r1[5], **kw)
    _k2_agree(k2, r2)
    assert 0 < int(k1[3].sum()) < int((k1[3] | k2[3]).sum())


def test_adaptive_kernel_refuses_what_it_does_not_take(dev):
    p, c, _ = _plant(cartpole, 5.0, dev)
    x0 = _x0(64, 4, 2, 0.5, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min, p.x_max)
    with pytest.raises(TypeError, match="float32"):
        K2.condensed_adaptive_cuda(*args, x0.double(), None, **_k2_kw(p, c))
    with pytest.raises(ValueError, match="contiguous"):
        K2.condensed_adaptive_cuda(*args, x0.T.contiguous().T, None,
                                   **_k2_kw(p, c))
    with pytest.raises(ValueError, match="plant"):
        K2.condensed_adaptive_cuda(*args, x0, None,
                                   **_k2_kw(p, c, plant=None))


def test_adaptive_api_and_pipeline_run_through_the_kernel(dev):
    s = quadrotor.make_solver(dtype=torch.float32, device=dev)
    s.update_settings(adaptive_rho=True, adaptive_rho_min=5.0,
                      adaptive_rho_max=1e3, max_iter=150,
                      adaptive_rho_controller="termination",
                      adaptive_rho_taylor_trust=2.0)
    x0 = _x0(3000, 12, 1, 0.3, dev)
    before = K2.condensed_adaptive_cuda.launches
    xs, us, it, ok, carry = s.solve_batch(x0, method="fused",
                                          return_carry=True)
    assert K2.condensed_adaptive_cuda.launches == before + 1
    assert xs.is_cuda and us.shape == (3000, N - 1, 4)
    assert int(ok.sum()) > 0.8 * 3000
    rho = carry.data.rho
    assert rho.shape == (1, 3000) and 5.0 <= float(rho.min())
    assert float(rho.max()) <= 7.0
    p = s.problem
    res = two_phase_adaptive_solve(
        build_condensed_taylor(p, s.cache), p.u_min, p.u_max, p.x_min,
        p.x_max, x0, nx=12, nu=4, N=N, straggler_slots=512)
    assert K2.condensed_adaptive_cuda.launches == before + 3
    assert int(res.overflow) == 0
    assert int(res.solved.sum()) >= 0.99 * 3000
