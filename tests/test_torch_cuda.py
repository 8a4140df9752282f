"""Kernels K1 (with and without its linear and cone projections, K1e; on its
group grid, K1d; with its reduced-precision product and head, K1c), K2
(per-lane adaptive rho; on its group grid) and K3 (the per-stage fused ADMM)
on the card: each CUDA kernel vs its plain PyTorch version, the port's main
paths through them (the fused MPC loop chained through K1's carry, the
bucketed rebuild and the requantized adaptive continuation among them),
and the single-instance and chunked float64 solves on the card; a
checkpoint round trip on the card and across to the CPU, an exported solve
made and called on the card, and a profiler trace with the card's kernel
events.  Every test here
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
from tinympc_julia_tpu_torch.ops.cuda import fused as K3
from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
from tinympc_julia_tpu_torch.parallel import (GroupedBatchSolver, mpc,
                                              three_phase_solve,
                                              two_phase_adaptive_solve)
from tinympc_julia_tpu_torch.types import ConeSet, stack_instances

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

N = 20


@pytest.fixture
def dev():
    """The first CUDA device; skips where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
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


def _counts_and_values_agree(k, r):
    """>= 99% equal per-lane counts; on those lanes (solved or not) the
    controls and states within 1e-4."""
    same = (k[2] == r[2]) & (k[3] == r[3])
    assert same.float().mean().item() >= 0.99
    for j in (0, 1):
        assert (k[j] - r[j])[same].abs().max().item() <= 1e-4


@pytest.mark.parametrize("horizon,kw", [
    (40, dict(max_iter=400)),
    (40, dict(max_iter=24, precision="default")),
    (57, dict(max_iter=400)),
    (57, dict(max_iter=200, bf16_head_iters=16)),
], ids=["sw636", "sw636-default", "sw908", "sw908-head16"])
def test_wide_map_matches_plain_version(dev, horizon, kw):
    """K1 at the quadrotor's horizons 40 and 57 (maps of 636 and 908 rows,
    wider than the product's 16 thread rows cover at once): the product in
    passes, the first passes' sums parked; fp32 and reduced (every
    iteration but the checks, or a 16-iteration head: at 908 rows the
    plain version's cuBLAS product of the checking iterations need not sum
    in index order, so the unsolved lanes of a short all-reduced launch are
    no yardstick there)."""
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, horizon,
                     u_min=-0.5, u_max=0.5, dtype=torch.float32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    maps = build_condensed(p, c)
    reduced = "precision" in kw or "bf16_head_iters" in kw
    plan = K.fused_tile_plan(12, 4, horizon, reduced)
    assert plan.passes > 1
    x0 = _x0(256 if "precision" in kw else 1024, 12, 3, 0.3, dev)
    args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0)
    full = _kw(12, 4, N=horizon, check_termination=4, **kw)
    before = K.condensed_fused_cuda.reduced_launches
    k = K.condensed_fused_cuda(*args, **full)
    r = K.condensed_fused_reference(*args, **full)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.reduced_launches == before + reduced
    if "precision" in kw:
        _counts_and_values_agree(k, r)
    else:
        _agree(k, r)


def test_adaptive_kernel_taylor_order_4(dev):
    """Taylor order 4 (five T1 blocks in turn, Horner in registers) on the
    card against the plain version."""
    p, c, _ = _plant(cartpole, 5.0, dev)
    args = (build_condensed_taylor(p, c, order=4), p.u_min, p.u_max,
            p.x_min, p.x_max, _x0(1000, 4, 0, 0.5, dev), None)
    k = K2.condensed_adaptive_cuda(*args, **_k2_kw(p, c))
    r = K2.condensed_adaptive_reference(*args, **_k2_kw(p, c))
    assert int(k[3].sum()) > 500
    _k2_agree(k, r)


def test_adaptive_reduced_precision_matches_plain_version(dev):
    """``precision="default"`` at ct = 5: the products of the iterations
    that neither check nor predict rho on the tensor cores, against the
    plain version's emulation of them; at ct = 1 every iteration checks,
    so the launch equals the full-precision one bit for bit."""
    p, c, _ = _plant(cartpole, 5.0, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(1000, 4, 4, 0.5, dev), None)
    kw = _k2_kw(p, c, check_termination=5, precision="default")
    before = K2.condensed_adaptive_cuda.reduced_launches
    k = K2.condensed_adaptive_cuda(*args, **kw)
    r = K2.condensed_adaptive_reference(*args, **kw)
    assert K2.condensed_adaptive_cuda.reduced_launches == before + 1
    _counts_and_values_agree(k, r)
    _k2_agree(k, r)
    full = K2.condensed_adaptive_cuda(*args, **_k2_kw(p, c))
    ct1 = K2.condensed_adaptive_cuda(*args,
                                     **_k2_kw(p, c, precision="default"))
    for a, b in zip(full[:5] + tuple(full[5]), ct1[:5] + tuple(ct1[5])):
        assert torch.equal(a, b)


def test_adaptive_continuation_matches_plain_version(dev):
    """A continuation-sized launch (2,048 quadrotor slots: 64 tiles of 32
    on the card), warm from a bulk pass's carry, against the plain version
    on the same inputs; and the quadrotor at N = 40, each product in two
    passes of 320 rows."""
    p, c, _ = _plant(quadrotor, 0.5, dev)
    tm = build_condensed_taylor(p, c)
    bounds = (p.u_min, p.u_max, p.x_min, p.x_max)
    x0 = _x0(2048, 12, 5, 0.3, dev)
    kw = _k2_kw(p, c, max_iter=30, **_QUAD_KW)
    bulk = K2.condensed_adaptive_cuda(tm, *bounds, x0, None, **kw)
    kw = dict(kw, max_iter=300, warm_start=True)
    before = K2.condensed_adaptive_cuda.warm_launches
    k = K2.condensed_adaptive_cuda(tm, *bounds, x0, bulk[5], **kw)
    assert K2.condensed_adaptive_cuda.warm_launches == before + 1
    r = K2.condensed_adaptive_reference(tm, *bounds, x0, bulk[5], **kw)
    assert int(k[3].sum()) > 1024
    _k2_agree(k, r)
    pw = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                      np.diag(quadrotor.R_DIAG), quadrotor.RHO, 40,
                      u_min=-0.5, u_max=0.5, dtype=torch.float32,
                      device=dev)
    cw = precompute_cache(pw.A, pw.B, pw.Q, pw.R, pw.rho_setup)
    args = (build_condensed_taylor(pw, cw), pw.u_min, pw.u_max, pw.x_min,
            pw.x_max, x0[:1024], None)
    kw = dict(_k2_kw(pw, cw, max_iter=300, **_QUAD_KW), N=40)
    k = K2.condensed_adaptive_cuda(*args, **kw)
    assert K2.adaptive_tile_plan(12, 4, 40, 2).passes1 == 2
    r = K2.condensed_adaptive_reference(*args, **kw)
    # at 637 columns cuBLAS need not sum the plain version's products in
    # index order: K1's bar (the lanes both solved)
    _agree(k, r)
    both = (k[2] == r[2]) & (k[3] == 1) & (r[3] == 1)
    assert ((k[4] - r[4]).abs() / r[4])[both].max().item() <= 1e-4


@pytest.mark.parametrize("kw", [dict(max_iter=300),
                                dict(max_iter=300, check_termination=5,
                                     precision="default")],
                         ids=["fp32", "default"])
def test_adaptive_wide_maps_take_tiles_of_16(dev, kw):
    """The quadrotor at N = 80 (sw 1,276): the iterates of 32 lanes leave no
    room beside the slab ring, so the launch runs tiles of 16 lanes, each
    product in five passes; against the plain version on K1's bar (at 1,277
    columns cuBLAS need not sum in index order)."""
    Nw = 80
    pw = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                      np.diag(quadrotor.R_DIAG), quadrotor.RHO, Nw,
                      u_min=-0.5, u_max=0.5, dtype=torch.float32,
                      device=dev)
    cw = precompute_cache(pw.A, pw.B, pw.Q, pw.R, pw.rho_setup)
    plan = K2.adaptive_tile_plan(12, 4, Nw, 2, "precision" in kw)
    assert plan.tile == 16 and plan.passes1 > 1
    args = (build_condensed_taylor(pw, cw), pw.u_min, pw.u_max, pw.x_min,
            pw.x_max, _x0(512, 12, 6, 0.3, dev), None)
    full = _k2_kw(pw, cw, **dict(_QUAD_KW, **kw))
    k = K2.condensed_adaptive_cuda(*args, **full)
    r = K2.condensed_adaptive_reference(*args, **full)
    torch.cuda.synchronize()
    same = (k[2] == r[2]) & (k[3] == r[3])
    assert same.float().mean().item() >= 0.99
    both = same & (k[3] == 1) & (r[3] == 1)
    if "precision" not in kw:
        assert int(both.sum()) > 256
    # under bf16 noise at ct = 5 few lanes, or none, pass a true check
    if bool(both.any()):
        for j in (0, 1):
            assert (k[j] - r[j])[both].abs().max().item() <= 1e-4
        assert ((k[4] - r[4]).abs() / r[4])[both].max().item() <= 1e-4


# -- the group grid (K1d, K2) and the reduced-precision head (K1c) ------------

def _groups(model, G, dev, *, ub_range, seed, x_bound=None, horizon=N):
    """G randomised plants (perturbed dynamics, input gain, costs, rho and
    input bounds) stacked along a leading group axis."""
    rng = np.random.default_rng(seed)
    nx = model.A.shape[0]
    ps, cs = [], []
    for _ in range(G):
        kw = {}
        if x_bound is not None:
            xb = np.tile(x_bound * rng.uniform(0.8, 1.2), (horizon, 1))
            kw = dict(x_min=-xb, x_max=xb)
        ub = rng.uniform(*ub_range)
        p = make_problem(
            model.A + rng.normal(scale=2e-3, size=(nx, nx)),
            model.B * rng.uniform(0.9, 1.1),
            np.diag(model.Q_DIAG * rng.uniform(0.8, 1.25, size=nx)),
            np.diag(model.R_DIAG), model.RHO * rng.uniform(0.8, 1.2),
            horizon, u_min=-ub, u_max=ub, dtype=torch.float32, device=dev,
            **kw)
        ps.append(p)
        cs.append(precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup))
    return stack_instances(ps), stack_instances(cs)


def _gx0(G, L, nx, seed, scale, dev):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -scale, scale, size=(G, L, nx)), dtype=torch.float32, device=dev)


@pytest.mark.parametrize("model,nx,nu,ub,kw", [
    (cartpole, 4, 1, (3.0, 6.0), {}),
    (cartpole, 4, 1, (3.0, 6.0), dict(check_termination=4)),
    (cartpole, 4, 1, (3.0, 6.0), dict(en_state_bound=True)),
    (quadrotor, 12, 4, (0.4, 0.6), dict(check_termination=4, max_iter=600)),
], ids=["ct1", "ct4", "per-group-state-bounds", "quadrotor"])
def test_group_grid_matches_plain_version(dev, model, nx, nu, ub, kw):
    """G = 5 groups x L = 300 lanes (a ragged last tile in every group),
    per-group maps, rho and bounds."""
    G, L = 5, 300
    x_bound = np.array([2.0, 1e17, 1e17, 1e17]) \
        if kw.get("en_state_bound") else None
    P, C = _groups(model, G, dev, ub_range=ub, seed=3, x_bound=x_bound)
    m = build_condensed(P, C)
    x0 = _gx0(G, L, nx, 4, 0.5 if nx == 4 else 0.25, dev)
    args = (m, C.rho, P.u_min, P.u_max, P.x_min, P.x_max, x0, None)
    before = K.condensed_fused_cuda.grouped_launches
    k = K.condensed_fused_cuda(*args, num_groups=G, **_kw(nx, nu, **kw))
    r = K.condensed_fused_reference(*args, num_groups=G, **_kw(nx, nu, **kw))
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.grouped_launches == before + 1
    _agree(k, r)
    same = k[2] == r[2]
    for a, b in zip(k[4], r[4]):
        assert (a - b)[:, same].abs().max().item() <= 1e-3


def test_group_grid_per_group_cones_and_warm_chain(dev):
    """The rocket with per-group cone coefficients, G = 3 x L = 250: kernel
    vs plain, and the kernel's 24 + 48 chain bit for bit its 72-iteration
    solve."""
    G, L = 3, 250
    rng = np.random.default_rng(6)
    xb = rocket.bounds()
    Xref, Uref = rocket.reference_trajectory(0)
    ps, cs = [], []
    for _ in range(G):
        cone = lambda lo, hi: ConeSet(mus=torch.tensor(
            [rng.uniform(lo, hi)], dtype=torch.float32, device=dev),
            starts=(0,), dims=(3,))
        p = make_problem(rocket.A, rocket.B, np.diag(rocket.Q_DIAG),
                         np.diag(rocket.R_DIAG), rocket.RHO, rocket.HORIZON,
                         f=rocket.F, x_min=xb[0].T, x_max=xb[1].T,
                         u_min=-10.0, u_max=105.0, Xref=Xref.T, Uref=Uref.T,
                         cones_u=cone(0.15, 0.35), cones_x=cone(0.4, 0.6),
                         dtype=torch.float32, device=dev)
        ps.append(p)
        cs.append(precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup))
    P, C = stack_instances(ps), stack_instances(cs)
    m = build_condensed(P, C)
    cons = K.fused_constraints(soc_u=K.cone_spec(P.cones_u),
                               soc_x=K.cone_spec(P.cones_x), nx=6, nu=3,
                               dtype=torch.float32, device=dev, num_groups=G)
    x0 = torch.as_tensor(rocket.X_INIT[None, None, :] * rng.uniform(
        0.9, 1.1, size=(G, L, 1)), dtype=torch.float32, device=dev)
    kw = dict(nx=6, nu=3, N=rocket.HORIZON, abs_pri_tol=2e-3,
              abs_dua_tol=1e-3, en_input_bound=True, en_state_bound=True,
              relaxation_alpha=1.0, check_termination=1, constraints=cons,
              num_groups=G)
    args = (m, C.rho, P.u_min, P.u_max, P.x_min, P.x_max, x0)
    k = K.condensed_fused_cuda(*args, None, max_iter=72, warm_start=False,
                               carry_out=True, **kw)
    r = K.condensed_fused_reference(*args, None, max_iter=72,
                                    warm_start=False, carry_out=True, **kw)
    _agree(k, r)
    a = K.condensed_fused_cuda(*args, None, max_iter=24, warm_start=False,
                               carry_out=True, **kw)
    b = K.condensed_fused_cuda(*args, a[4], max_iter=48, warm_start=True,
                               carry_out=False, **kw)
    done = a[3] == 1
    assert torch.equal(torch.where(done, a[2], 24 + b[2]), k[2])
    assert torch.equal(torch.where(done[:, None, None], a[1], b[1]), k[1])


@pytest.mark.parametrize("kw", [
    dict(max_iter=96, check_termination=4, bf16_head_iters=16),
    dict(max_iter=96, check_termination=4, precision="default"),
    dict(max_iter=60, check_termination=1, bf16_head_iters=1),
], ids=["head16-ct4", "default-ct4", "head1-ct1"])
def test_reduced_precision_matches_plain_version(dev, kw):
    """The bf16 rounding is exact on both sides and the plain version sums
    the products as the tensor cores do (``mma_product``): kernel and plain
    version agree as the fp32 solves do."""
    G, L = 3, 300
    P, C = _groups(cartpole, G, dev, ub_range=(3.0, 6.0), seed=7)
    m = build_condensed(P, C)
    x0 = _gx0(G, L, 4, 8, 0.5, dev)
    args = (m, C.rho, P.u_min, P.u_max, P.x_min, P.x_max, x0, None)
    before = K.condensed_fused_cuda.reduced_launches
    k = K.condensed_fused_cuda(*args, num_groups=G, **_kw(4, 1, **kw))
    r = K.condensed_fused_reference(*args, num_groups=G, **_kw(4, 1, **kw))
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.reduced_launches == before + 1
    same = k[2] == r[2]
    assert same.float().mean().item() >= 0.99
    assert (k[1] - r[1]).abs()[same].max().item() <= 1e-4
    for a, b in zip(k[4], r[4]):
        assert ((a - b)[:, same].abs()
                / b[:, same].abs().clamp(min=1.0)).max().item() <= 1e-3
    if kw.get("bf16_head_iters"):
        assert int(k[2].min()) >= kw["bf16_head_iters"]


@pytest.mark.parametrize("kw", [
    dict(max_iter=600),
    dict(max_iter=160, precision="default"),
    dict(max_iter=600, bf16_head_iters=64),
    dict(max_iter=600, bf16_head_iters=64, en_state_bound=True),
], ids=["K1d-fp32", "K1c-default", "K1c-head64", "K1c-head64-state-dual"])
def test_quadrotor_tile_design_matches_plain_version(dev, kw):
    """The quadrotor shape (sw = 316), where T12 does not fit in shared
    memory: the tile design streams it through shared memory in slabs (fp32
    FMAs in index order; a reduced iteration's product on the tensor
    cores), G = 4 x L = 200 with per-group maps.  With a state bound and
    reduced iterations the lanes' state (948 floats a lane with the state
    dual) no longer fits beside the tile and stays in global memory.  The
    card's bar: >= 99% equal counts, 1e-4 on the lanes with equal counts
    that both solved."""
    G, L = 4, 200
    reduced = "precision" in kw or "bf16_head_iters" in kw
    bounded = kw.get("en_state_bound", False)
    plan = K.fused_tile_plan(12, 4, N, reduced, state_free=not bounded)
    assert not plan.resident  # streamed
    assert plan.state_shared is not (reduced and bounded)
    x_bound = np.r_[np.full(3, 1.0), np.full(9, 1e17)] if bounded else None
    P, C = _groups(quadrotor, G, dev, ub_range=(0.4, 0.6), seed=7,
                   x_bound=x_bound)
    m = build_condensed(P, C)
    x0 = _gx0(G, L, 12, 8, 0.25, dev)
    args = (m, C.rho, P.u_min, P.u_max, P.x_min, P.x_max, x0, None)
    full = _kw(12, 4, check_termination=4, num_groups=G, **kw)
    k = K.condensed_fused_cuda(*args, **full)
    r = K.condensed_fused_reference(*args, **full)
    torch.cuda.synchronize()
    same = k[2] == r[2]
    assert same.float().mean().item() >= 0.99
    both = same & (k[3] == 1) & (r[3] == 1)
    if "precision" not in kw:
        assert int(both.sum()) > G * L // 2
    if bool(both.any()):
        assert (k[1] - r[1]).abs()[both].max().item() <= 1e-4
        assert (k[0] - r[0]).abs()[both].max().item() <= 1e-4
    assert bool(torch.isfinite(k[0]).all()) and bool(torch.isfinite(k[1]).all())


@pytest.mark.parametrize("kw", [
    dict(max_iter=200), dict(max_iter=96, bf16_head_iters=32)],
    ids=["fp32", "reduced"])
def test_lane_results_do_not_depend_on_tile_mates(dev, kw):
    """A lane's counts, outputs and carry are bit for bit the same when its
    batch of 4,096 quadrotor lanes is permuted (other tile-mates, another
    tile position), in fp32 and with reduced iterations."""
    p, c, m = _plant(quadrotor, quadrotor.U_HOVER_BOUND, dev)
    x0 = _x0(4096, 12, 5, 0.3, dev)
    perm = torch.as_tensor(np.random.default_rng(6).permutation(4096),
                           device=dev)
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max)
    full = _kw(12, 4, check_termination=4, **kw)
    a = K.condensed_fused_cuda(*args, x0, **full)
    b = K.condensed_fused_cuda(*args, x0[perm].contiguous(), **full)
    torch.cuda.synchronize()
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x[perm], y)
    for x, y in zip(a[4], b[4]):
        assert torch.equal(x[:, perm], y)
    assert int(a[3].sum()) > 0


def test_results_do_not_follow_the_callers_tf32_setting(dev):
    """With ``allow_tf32 = True`` set by the caller, the Riccati cache, the
    condensed solve, K1's plain version and K1 itself compute the same bits
    as with TF32 off (where an unpinned fp32 matmul would not)."""
    from tinympc_julia_tpu_torch import Settings
    from tinympc_julia_tpu_torch.ops.condensed import solve_condensed
    prev = torch.backends.cuda.matmul.allow_tf32
    runs = []
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            p, c, m = _plant(quadrotor, quadrotor.U_HOVER_BOUND, dev)
            x0 = _x0(512, 12, 1, 0.3, dev)
            args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0)
            full = _kw(12, 4, check_termination=4, max_iter=300)
            runs.append((c.Kinf, c.Pinf,
                         *K.condensed_fused_reference(*args, **full)[:4],
                         *K.condensed_fused_cuda(*args, **full)[:4],
                         *solve_condensed(p, c, Settings(max_iter=60), x0)))
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        a = torch.randn(316, 316, device=dev)
        plain = [None, None]
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            plain[flag] = a @ a
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    assert not torch.equal(plain[False], plain[True])


def test_head_equals_the_chained_launches(dev):
    """One launch with a 16-iteration head is bit for bit the (16, ct = 16,
    "default", carry out) launch chained into a warm fp32 launch."""
    p, c, m = _plant(cartpole, 5.0, dev)
    x0 = _x0(1000, 4, 9, 0.5, dev)
    args = (m, c.rho, p.u_min, p.u_max, p.x_min, p.x_max, x0)
    head = K.condensed_fused_cuda(*args, None, **_kw(
        4, 1, max_iter=96, check_termination=4, bf16_head_iters=16))
    a = K.condensed_fused_cuda(*args, None, **_kw(
        4, 1, max_iter=16, check_termination=16, precision="default"))
    b = K.condensed_fused_cuda(*args, a[4], **_kw(
        4, 1, max_iter=80, check_termination=4, warm_start=True))
    done = a[3] == 1
    assert torch.equal(torch.where(done, a[2], 16 + b[2]), head[2])
    assert torch.equal(torch.where(done[:, None, None], a[1], b[1]), head[1])
    for x, y in zip(b[4], head[4]):
        assert torch.equal(x, y)


def test_reduced_phases_latch_on_true_residuals(dev):
    """Every lane latched inside a reduced phase (a "default" launch at
    ct = 4, and a head that ends on its only check) passes the tolerance
    when its residuals are recomputed in fp32 by the plain version: one
    more full-precision iteration from the carry, which froze just before
    the latch, latches at once and returns the same controls."""
    p, c, m = _plant(cartpole, 5.0, dev)
    x0 = _x0(4096, 4, 10, 0.2, dev)
    args = (m, c.rho, p.u_min, p.u_max, p.x_min, p.x_max, x0)
    for kw in (dict(max_iter=96, check_termination=4, precision="default"),
               dict(max_iter=32, check_termination=32, precision="default")):
        k = K.condensed_fused_cuda(*args, None, **_kw(4, 1, **kw))
        latched = k[3] == 1
        assert int(latched.sum()) > 100
        again = K.condensed_fused_reference(*args, k[4], **_kw(
            4, 1, max_iter=1, check_termination=1, warm_start=True,
            carry_out=False))
        assert bool((again[3][latched] == 1).all())
        assert (again[1] - k[1])[latched].abs().max().item() <= 1e-5


@pytest.mark.parametrize("controller,state_bound", [
    ("osqp", False), ("osqp", True), ("termination", False)])
def test_adaptive_group_grid_matches_plain_version(dev, controller,
                                                   state_bound):
    G, L = 4, 300
    x_bound = np.array([0.5, 1e17, 1e17, 1e17]) if state_bound else None
    P, C = _groups(cartpole, G, dev, ub_range=(3.0, 6.0), seed=11,
                   x_bound=x_bound)
    t = build_condensed_taylor(P, C)
    x0 = _gx0(G, L, 4, 12, 0.5, dev)
    kw = dict(plant=K2.AdaptivePlant(P.A, P.B, P.Q, P.R, C.Pinf,
                                     C.dPinf_drho),
              nx=4, nu=1, N=N, max_iter=200, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=state_bound,
              en_input_bound=True, relaxation_alpha=1.0,
              adaptive_rho_min=0.3, adaptive_rho_max=8.0,
              adaptive_rho_clipping=True, check_termination=1,
              controller=controller,
              taylor_trust=0.5 if controller == "termination"
              else float("inf"), warm_start=False, carry_out=True,
              num_groups=G)
    args = (t, P.u_min, P.u_max, P.x_min, P.x_max, x0, None)
    before = K2.condensed_adaptive_cuda.grouped_launches
    k = K2.condensed_adaptive_cuda(*args, **kw)
    r = K2.condensed_adaptive_reference(*args, **kw)
    torch.cuda.synchronize()
    assert K2.condensed_adaptive_cuda.grouped_launches == before + 1
    same = (k[2] == r[2]) & (k[3] == r[3])
    assert same.float().mean().item() >= 0.99
    assert (k[1] - r[1])[same].abs().max().item() <= 1e-4
    assert ((k[4] - r[4]).abs() / r[4])[same].max().item() <= 1e-4
    rho0 = C.rho.repeat_interleave(L)
    assert bool((k[4] != rho0).any())


def test_grouped_solver_runs_through_the_kernels(dev):
    """``GroupedBatchSolver`` on the card: the fused method and the staged
    two-phase pipeline launch K1 on its group grid; the pipeline equals the
    same pipeline on the plain version."""
    from tinympc_julia_tpu_torch import Settings
    G, L = 4, 500
    P, C = _groups(cartpole, G, dev, ub_range=(3.0, 6.0), seed=13)
    gs = GroupedBatchSolver(P, C, Settings(
        max_iter=80, en_state_bound=False, relaxation_alpha=1.7,
        check_termination=4))
    x0 = _gx0(G, L, 4, 14, 0.6, dev)
    before = K.condensed_fused_cuda.grouped_launches
    xs, us, it, ok = gs.solve_batch(x0, method="fused")
    assert K.condensed_fused_cuda.grouped_launches == before + 1
    assert us.is_cuda and us.shape == (G, L, N - 1, 1)
    c = gs.solve_batch(x0, method="condensed")
    same = c[2] == it
    assert same.float().mean().item() >= 0.99
    assert (c[1] - us)[same].abs().max().item() <= 2e-4
    out = gs.solve_batch(x0, method="fused", pipeline=dict(
        phase0_bf16_iters=16, phase1_iters=32, straggler_slots=L,
        phase2_iters=300, phase2_bf16_head=32))
    assert K.condensed_fused_cuda.grouped_launches == before + 4
    assert gs.last_overflow.tolist() == [0] * G
    assert int(out[3].sum()) >= 0.99 * G * L


# -- kernel K3 (the per-stage fused ADMM) and the fused MPC loop --------------

def _k3_args(p, c, x0):
    return (p.A, p.B, p.f, p.Q, p.R, c.rho, c.Kinf, c.Quu_inv, c.AmBKt,
            c.Pinf, p.x_min, p.x_max, p.u_min, p.u_max, p.Xref, p.Uref, x0)


@pytest.mark.parametrize("model,nx,nu,ub,kw", [
    (cartpole, 4, 1, 5.0, {}),
    (cartpole, 4, 1, 5.0, dict(check_termination=4)),
    (cartpole, 4, 1, 5.0, dict(en_state_bound=True)),
    (cartpole, 4, 1, 5.0, dict(en_state_bound=True, check_termination=4,
                               max_iter=102)),
    (cartpole, 4, 1, 0.5, dict(en_input_bound=False, max_iter=30)),
    (cartpole, 4, 1, 5.0, dict(rho="float")),
    (quadrotor, 12, 4, 0.5, dict(max_iter=500)),
    (quadrotor, 12, 4, 0.5, dict(check_termination=4, max_iter=302,
                                 rho="float")),
], ids=["ct1", "ct4", "state-bounded", "state-bounded-ct4",
        "no-input-bound", "rho-float", "quadrotor", "quadrotor-ct4"])
def test_stage_kernel_matches_plain_version(dev, model, nx, nu, ub, kw):
    """K3 vs plain on 1,001 lanes (a ragged last tile for every lane group
    up to 8) at the lane group the plan takes for the shape; under the
    state bound the cart position binds at 0.3.  One launch, results in
    the returned layout; rho as the cache's 0-d CUDA tensor or as a float
    (the same results); a max_iter that is no multiple of the check
    interval; without the input bound |u| leaves it."""
    kw = dict(kw)
    rho_kind = kw.pop("rho", "tensor")
    bounded = kw.get("en_state_bound", False)
    p, c, _ = _plant(model, ub, dev, np.array([0.3, 1e17, 1e17, 1e17])
                     if bounded else None)
    x0 = _x0(1001, nx, 0, 0.5 if nx == 4 else 0.3, dev)
    if bounded:
        x0 = x0 * torch.tensor([0.5, 2.0, 1.0, 1.0], device=dev)
    full = dict(nx=nx, nu=nu, N=N, max_iter=100, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                check_termination=1)
    full.update(kw)
    plan = K3.fused_stage_plan(nx, nu, N, full["en_state_bound"], 1001,
                               torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
    assert plan.group == {4: 1, 12: 4}[nx] and plan.registers
    args = _k3_args(p, c, x0)
    if rho_kind == "float":
        args = args[:5] + (float(c.rho),) + args[6:]
    before = K3.fused_cuda.launches
    k = K3.fused_cuda(*args, **full)
    torch.cuda.synchronize()
    assert K3.fused_cuda.launches == before + 1
    r = K3.fused_reference(*args, **full)
    assert k[0].shape == (1001, N, nx) and k[1].shape == (1001, N - 1, nu)
    assert k[0].is_contiguous() and k[1].is_contiguous()
    _agree(k, r)
    if rho_kind == "float":  # the same solve as with rho on the card
        t = K3.fused_cuda(*_k3_args(p, c, x0), **full)
        assert all(torch.equal(a, b) for a, b in zip(k, t))
    if bounded:
        assert float(k[0][..., 0].abs().max()) == pytest.approx(0.3, abs=1e-7)
    if not full["en_input_bound"]:
        assert float(k[1].abs().max()) > ub
    ct = full["check_termination"]
    lost = k[3] == 0
    assert bool((k[2][lost] == full["max_iter"]).all())
    assert bool((k[2][~lost] % ct == 0).all())


def test_stage_kernel_takes_lanes_from_its_queue(dev):
    """More quadrotor lanes than the card holds at once (64 an SM at G = 4):
    the groups whose lanes are done take the rest from the launch's queue.
    The same results as the plain version, and launch after launch (each
    launch leaves its queue at zero; more launches than queue slots)."""
    p, c, _ = _plant(quadrotor, 0.5, dev)
    x0 = _x0(12001, 12, 5, 0.3, dev)
    full = dict(nx=12, nu=4, N=N, max_iter=150, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                check_termination=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = K3.fused_stage_plan(12, 4, N, False, 12001, sms)
    occ = K3.stage_occupancy(plan, 12, 4, False)
    assert occ["blocks_per_sm"] * plan.tile * sms < 12001
    k = K3.fused_cuda(*_k3_args(p, c, x0), **full)
    _agree(k, K3.fused_reference(*_k3_args(p, c, x0), **full))
    small = x0[:300].contiguous()
    first = K3.fused_cuda(*_k3_args(p, c, small), **full)
    for _ in range(70):
        again = K3.fused_cuda(*_k3_args(p, c, small), **full)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a[:300], b) for a, b in zip(k, first))


@pytest.mark.parametrize("case", ["rocket-6x3", "generic-5x2",
                                  "generic-5x2-state-box"])
def test_stage_kernel_other_variants(dev, case):
    """The (6, 3) variant on the rocket (box only, the affine term,
    references) and the generic variant on a made-up 5 x 2 plant, with and
    without a state box."""
    rng = np.random.default_rng(9)
    kw = dict(max_iter=200)
    if case.startswith("rocket"):
        Xref, Uref = rocket.reference_trajectory(0)
        p = make_problem(rocket.A, rocket.B, np.diag(rocket.Q_DIAG),
                         np.diag(rocket.R_DIAG), rocket.RHO, rocket.HORIZON,
                         f=rocket.F, u_min=-10.0, u_max=105.0, Xref=Xref.T,
                         Uref=Uref.T, dtype=torch.float32, device=dev)
        x0 = _rocket_x0(1000, dev)
        kw.update(abs_pri_tol=2e-3)
    else:
        pk = {}
        if case.endswith("box"):
            xb = np.tile(np.full(5, 0.3), (12, 1))
            pk = dict(x_min=-xb, x_max=xb)
            kw.update(en_state_bound=True)
        p = make_problem(np.eye(5) + rng.normal(size=(5, 5)) * 0.05,
                         rng.normal(size=(5, 2)) * 0.1, np.eye(5), np.eye(2),
                         1.0, 12, u_min=-1.0, u_max=1.0, dtype=torch.float32,
                         device=dev, **pk)
        x0 = _x0(1000, 5, 3, 0.25, dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    full = dict(nx=p.nx, nu=p.nu, N=p.N, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                en_state_bound=False, en_input_bound=True,
                check_termination=1)
    full.update(kw)
    k = K3.fused_cuda(*_k3_args(p, c, x0), **full)
    r = K3.fused_reference(*_k3_args(p, c, x0), **full)
    torch.cuda.synchronize()
    _agree(k, r)


def test_stage_solver_launches_the_kernel_and_agrees_with_k1(dev):
    """``make_fused_solver`` on CUDA tensors is one K3 launch; K1 at alpha 1
    and ct 1 is the same ADMM: equal counts on >= 99% of lanes."""
    p, c, m = _plant(cartpole, 5.0, dev)
    x0 = _x0(3000, 4, 3, 0.5, dev)
    before = K3.fused_cuda.launches
    xs, us, it, ok = K3.make_fused_solver(4, 1, N, max_iter=100)(
        *_k3_args(p, c, x0))
    assert K3.fused_cuda.launches == before + 1
    assert us.is_cuda and us.shape == (3000, N - 1, 1)
    k1 = K.condensed_fused_cuda(
        m, c.rho, p.u_min, p.u_max, p.x_min, p.x_max, x0, None,
        **_kw(4, 1, max_iter=100, relaxation_alpha=1.0, carry_out=False))
    same = k1[2] == it
    assert same.float().mean().item() >= 0.99
    both = same & (ok == 1) & (k1[3] == 1)
    assert int(both.sum()) > 1500
    assert (us - k1[1]).abs()[both].max().item() <= 1e-4


def test_stage_kernel_refuses_what_it_does_not_take(dev):
    p, c, _ = _plant(cartpole, 5.0, dev)
    x0 = _x0(64, 4, 2, 0.5, dev)
    fn = K3.make_fused_solver(4, 1, N)
    with pytest.raises(TypeError, match="float32"):
        fn(*_k3_args(p, c, x0.double()))
    with pytest.raises(ValueError, match="contiguous"):
        fn(*_k3_args(p, c, x0.T.contiguous().T))
    # every input is read as it lies: a strided matrix is refused, not copied
    args = list(_k3_args(p, c, x0))
    args[8] = c.AmBKt.T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        fn(*args)
    args = list(_k3_args(p, c, x0))
    args[5] = c.rho.double()
    with pytest.raises(TypeError, match="float32"):
        fn(*args)


def test_fused_mpc_loop_runs_through_the_kernel(dev):
    """2,000 plants x 20 steps: 20 K1 launches chained through the carry,
    against the same loop on the plain version."""
    from tinympc_julia_tpu_torch import Settings
    p, c, _ = _plant(cartpole, 5.0, dev)
    s = Settings(max_iter=100, en_state_bound=False, relaxation_alpha=1.7)
    x0 = _x0(2000, 4, 3, 0.5, dev)
    before = K.condensed_fused_cuda.launches
    res = mpc.make_fused_mpc_loop(p, c, s, 20)(x0)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.launches == before + 20
    ref = mpc.make_fused_mpc_loop(p, c, s, 20,
                                  fused=K.condensed_fused_reference)(x0)
    assert K.condensed_fused_cuda.launches == before + 20
    assert res.us.is_cuda and res.us.shape == (2000, 20, 1)
    assert (res.iters == ref.iters).float().mean().item() >= 0.99
    assert (res.us - ref.us).abs().max().item() <= 1e-4
    # the first steps' solves are the hard ones: 98.4% over these 20 steps
    # on an H100, 99.7% over the bench row's 100
    assert res.solved.float().mean().item() >= 0.97
    assert float(res.us.abs().max()) <= 5.0 + 1e-5


@pytest.mark.parametrize("model,ub,x_bound,scale,rho0,span,slots", [
    (cartpole, 5.0, np.array([2.0, 1e17, 1e17, 1e17]),
     np.array([1.8, 1.0, 0.4, 0.5]), 0.01, (1e-4, 1e4), 512),
    (cartpole, 5.0, np.array([2.0, 1e17, 1e17, 1e17]),
     np.array([1.8, 1.0, 0.4, 0.5]), 0.01, (1e-4, 1e4), 32),
    (quadrotor, quadrotor.U_HOVER_BOUND, None, 0.3, 0.05, (1e-3, 1e3), 512),
], ids=["cartpole", "cartpole-overflow", "quadrotor"])
def test_rebuild_pipeline_matches_plain_version(dev, model, ub, x_bound,
                                                scale, rho0, span, slots):
    """The bucketed rebuild on the mis-set cartpole and quadrotor (B = 512):
    K1 for phase 1, K1d over the buckets for phase 2 (buckets with no
    straggler are tiles of pad slots only), against the same pipeline on
    the plain version; with 32 slots a bucket, an overflowing bucket."""
    from tinympc_julia_tpu_torch import Settings
    from tinympc_julia_tpu_torch.parallel.rebuild import make_bucketed_rebuild
    kw = {}
    if x_bound is not None:
        xb = np.tile(x_bound, (N, 1))
        kw = dict(x_min=-xb, x_max=xb)
    p = make_problem(model.A, model.B, np.diag(model.Q_DIAG),
                     np.diag(model.R_DIAG), rho0, N, u_min=-ub, u_max=ub,
                     dtype=torch.float32, device=dev, **kw)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    s = Settings(max_iter=500, en_state_bound=x_bound is not None,
                 en_input_bound=True, adaptive_rho_min=span[0],
                 adaptive_rho_max=span[1])
    x0 = torch.as_tensor(np.random.default_rng(5).uniform(
        -1, 1, size=(512, p.nx)) * scale, dtype=torch.float32,
        device=dev)
    kw = dict(phase1_iters=50, straggler_slots=slots, phase2_iters=450)
    before = K.condensed_fused_cuda.grouped_launches
    out = make_bucketed_rebuild(p, c, s, **kw).solve(x0)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.grouped_launches == before + 1
    ref = make_bucketed_rebuild(p, c, s, fused=K.condensed_fused_reference,
                                **kw).solve(x0)
    _agree(out, ref)
    same = out[2] == ref[2]
    assert torch.equal(out[4][same], ref[4][same])
    assert torch.equal(out[5], ref[5])
    assert (int(out[5].sum()) > 0) == (slots == 32)
    assert (out[5] == 0).any()  # a bucket of pad slots only
    if slots == 512:
        assert int(out[3].sum()) >= 0.95 * 512


def test_requantized_pipeline_matches_plain_version(dev):
    """The requantized adaptive continuation on the quadrotor (B = 2,048,
    256 slots a bucket): K2's bulk pass, then K1d with its 256-iteration
    reduced head over the three exact buckets, against the same pipeline on
    the plain versions."""
    from tinympc_julia_tpu_torch.ops.cuda.adaptive_kernel import (
        condensed_adaptive_reference)
    from tinympc_julia_tpu_torch.parallel.pipeline import (
        requantized_adaptive_solve, requantized_buckets)
    p, c, _ = _plant(quadrotor, quadrotor.U_HOVER_BOUND, dev)
    tmaps = build_condensed_taylor(p, c)
    rhos, bmaps = requantized_buckets(p, c)
    x0 = _x0(2048, 12, 1, 0.3, dev)
    args = (tmaps, bmaps, rhos, p.u_min, p.u_max, p.x_min, p.x_max, x0)
    kw = dict(nx=12, nu=4, N=N, straggler_slots=256)
    before = K.condensed_fused_cuda.reduced_launches
    res = requantized_adaptive_solve(*args, **kw)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.reduced_launches == before + 1
    ref = requantized_adaptive_solve(
        *args, fused_adaptive=condensed_adaptive_reference,
        fused=K.condensed_fused_reference, **kw)
    _agree((res.xs, res.us, res.iters, res.solved),
           (ref.xs, ref.us, ref.iters, ref.solved))
    same = res.iters == ref.iters
    torch.testing.assert_close(res.rho[same], ref.rho[same], rtol=1e-4,
                               atol=0)
    assert torch.equal(res.overflow, ref.overflow)
    assert int(res.unconv.sum()) > 0
    assert res.solved.float().mean().item() >= 0.99


def test_chunked_float64_solve_card_vs_cpu(dev):
    """A float64 cartpole at N = 257 on the chunked recursions (chunks of
    128 stages) and on the associative scans: the card's solve and batch
    solve equal the CPU's (counts, controls within 1e-9)."""
    out = []
    for d in (dev, torch.device("cpu")):
        s = TinyMPCSolver(dtype=torch.float64, device=d)
        s.setup(cartpole.A, cartpole.B, None, np.diag(cartpole.Q_DIAG),
                np.diag(cartpole.R_DIAG), 1.0, 4, 1, 257, max_iter=100)
        s.set_bound_constraints(np.full((4, 257), -1e17),
                                np.full((4, 257), 1e17),
                                np.full((1, 256), -5.0), np.full((1, 256), 5.0))
        s.set_x0([1.0, 0.0, 0.2, 0.0])
        s.solve(chunked=True)
        chunked = (int(s.solution.iter), s.get_solution().controls)
        s.horizon_parallel = True
        s.set_x0([1.0, 0.0, 0.2, 0.0])
        s.solve()
        assoc = (int(s.solution.iter), s.get_solution().controls)
        b = s.solve_batch(np.random.default_rng(8).uniform(
            -0.5, 0.5, size=(8, 4)), method="chunked")
        out.append((chunked, assoc, b[2].cpu(), b[1].cpu()))
    (ck, ak, bik, buk), (ch, ah, bih, buh) = out
    assert ck[0] == ch[0] and ak[0] == ah[0] and torch.equal(bik, bih)
    np.testing.assert_allclose(ck[1], ch[1], atol=1e-9)
    np.testing.assert_allclose(ak[1], ah[1], atol=1e-9)
    torch.testing.assert_close(buk, buh, atol=1e-9, rtol=0)


def _cartpole_loop(solvers, x, n):
    """``n`` closed-loop steps of every solver from ``x`` (the plant driven
    by the first one); returns the last x, the controls and the counts."""
    us, its = [[] for _ in solvers], [[] for _ in solvers]
    for _ in range(n):
        for k, s in enumerate(solvers):
            s.set_x0(x)
            s.solve()
            us[k].append(s.get_solution().controls)
            its[k].append(int(s.solution.iter))
        x = cartpole.simulate(x, us[0][-1][:, 0])
    return x, us, its


def test_checkpoint_on_the_card_and_across_to_the_cpu(dev, tmp_path):
    """A float64 cartpole saved on the card mid closed loop: loaded on the
    card it resumes bit for bit; loaded on the CPU it agrees (equal counts,
    controls within 1e-12)."""
    s = cartpole.make_solver(device=dev, dtype=torch.float64,
                             max_iter=100, constrained=True)
    s.update_settings(relaxation_alpha=1.7)
    x, _, _ = _cartpole_loop([s], np.array([0.0, 0.0, 0.1, 0.0]), 10)
    path = str(tmp_path / "card.npz")
    s.save(path)
    on_card = TinyMPCSolver.load(path, device=dev)
    on_cpu = TinyMPCSolver.load(path, device="cpu")
    assert on_card.problem.A.is_cuda and on_card.state.x.is_cuda
    assert on_card.settings == s.settings == on_cpu.settings
    _, us, its = _cartpole_loop([s, on_card, on_cpu], x, 10)
    assert its[1] == its[0] and its[2] == its[0]
    for a, b, c in zip(*us):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_allclose(c, a, atol=1e-12, rtol=0)


def test_export_made_and_called_on_the_card(dev):
    """The exported batched solve, made on the card, runs on the card and
    gives the eager solve's counts and controls (1e-12, float64)."""
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    from tinympc_julia_tpu_torch.parallel import batch
    from tinympc_julia_tpu_torch.types import Settings, init_state
    from tinympc_julia_tpu_torch.utils import export

    p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                     np.diag(cartpole.R_DIAG), 1.0, N, u_min=-5.0,
                     u_max=5.0, dtype=torch.float64, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    st = batch.set_x0_batch(batch.broadcast_state(
        init_state(4, 1, N, dtype=torch.float64, device=dev), 64),
        _x0(64, 4, 6, 0.8, dev).double())
    s = Settings(max_iter=100, en_state_bound=False, relaxation_alpha=1.6)
    fn = export.load_solve(export.export_solve(p, c, s, st, batched=True))
    _, _, sol = fn(p, c, st)
    _, _, ref = batch.solve_batch(p, c, s, st)
    assert sol.u.is_cuda
    assert torch.equal(sol.iter, ref.iter)
    assert torch.equal(sol.solved, ref.solved)
    torch.testing.assert_close(sol.u, ref.u, atol=1e-12, rtol=0)


def test_export_of_the_exact_rebuild_on_the_card(dev):
    """adaptive_rho_rebuild exports as a fixed-point loop inside the solve's
    loop; made and called on the card it gives the eager solve's count and
    controls (1e-12, float64) with a moved rho."""
    from tinympc_julia_tpu_torch.ops import admm
    from tinympc_julia_tpu_torch.utils import export

    s = cartpole.make_solver(device=dev, dtype=torch.float64, max_iter=60,
                             adaptive_rho=True, adaptive_rho_min=0.5,
                             adaptive_rho_max=5.0, constrained=True)
    s.update_settings(adaptive_rho_controller="termination",
                      adaptive_rho_rebuild=True)
    s.set_x0([1.2, -0.3, 0.2, 0.1])
    args = (s.problem, s.cache, s.state)
    fn = export.load_solve(export.export_solve(s.problem, s.cache,
                                               s.settings, s.state))
    _, ca, sol = fn(*args)
    _, ca_ref, ref = admm.solve(s.problem, s.cache, s.settings, s.state)
    assert sol.u.is_cuda and int(sol.iter) == int(ref.iter)
    assert float(ca.rho) == float(ca_ref.rho) != float(s.cache.rho)
    torch.testing.assert_close(sol.u, ref.u, atol=1e-12, rtol=0)


def test_profiler_trace_holds_the_kernel(dev, tmp_path):
    """utils.profiling.trace around a fused batch solve: the trace names K1's
    CUDA symbol among its device events."""
    import json
    from tinympc_julia_tpu_torch.utils import profiling

    s = cartpole.make_solver(device=dev, dtype=torch.float32,
                             constrained=True)
    x0s = _x0(1024, 4, 7, 0.5, dev)
    s.solve_batch(x0s, method="fused")  # build and load before tracing
    with profiling.trace(str(tmp_path)):
        out = s.solve_batch(x0s, method="fused")
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "condensed_fused" in e.get("name", "")]
    assert kernels, "no K1 device event in the trace"
    assert profiling.solve_stats(
        type("S", (), dict(iter=out[2], solved=out[3]))())["n"] == 1024
