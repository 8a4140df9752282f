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
from tinympc_julia_tpu_torch.ops.cuda.layout_probe import same_bits
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
def test_wide_map_matches_plain_version(dev, monkeypatch, horizon, kw):
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
    # w2 in shared memory, in passes (from sw 908 the plan itself takes the
    # cluster layout, which the cluster tests cover)
    plan = K.shared_tile_plan(12, 4, horizon, reduced)
    assert plan.passes > 1
    _forced(monkeypatch, K, "fused_tile_plan", plan)
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
def test_adaptive_wide_maps_take_tiles_of_16(dev, monkeypatch, kw):
    """The quadrotor at N = 80 (sw 1,276): the iterates of 32 lanes leave no
    room beside the slab ring, so the shared-memory layout runs tiles of 16
    lanes, each product in five passes (forced: from sw 908 the plan takes
    the cluster); against the plain version on K1's bar (at 1,277 columns
    cuBLAS need not sum in index order)."""
    Nw = 80
    pw = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                      np.diag(quadrotor.R_DIAG), quadrotor.RHO, Nw,
                      u_min=-0.5, u_max=0.5, dtype=torch.float32,
                      device=dev)
    cw = precompute_cache(pw.A, pw.B, pw.Q, pw.R, pw.rho_setup)
    plan = K2.shared_adaptive_plan(12, 4, Nw, 2, "precision" in kw)
    assert plan.tile == 16 and plan.passes1 > 1
    _forced(monkeypatch, K2, "adaptive_tile_plan", plan)
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


def test_sharded_solve_world_of_one_on_the_card(dev):
    """make_mesh() with no process group is a world of one on the card, and
    solve_sharded there equals solve_batch to the bit."""
    from tinympc_julia_tpu_torch.examples.batched_scenario_sweep import (
        scenario)
    from tinympc_julia_tpu_torch.parallel import (make_mesh, shard_state,
                                                  solve_batch, solve_sharded)

    mesh = make_mesh()
    assert mesh.world == 1 and mesh.device.type == "cuda"
    p, c, s, st = scenario(1024, mesh.device)
    _, _, sol = solve_sharded(p, c, s, shard_state(st, mesh), mesh)
    _, _, ref = solve_batch(p, c, s, st)
    assert sol.u.is_cuda and int(sol.solved.sum()) > 0
    for k in ("iter", "solved", "x", "u"):
        assert torch.equal(getattr(sol, k), getattr(ref, k)), k


def test_sharded_vote_on_two_ranks_of_the_card(dev, tmp_path):
    """The dry run's leg 1 at its small shapes on two gloo ranks sharing the
    card: each rank's sharded block, vote on and off, equals its block
    solved alone bit for bit (the ranks check it; a rank that fails fails
    the run)."""
    from tinympc_julia_tpu_torch import dryrun

    paths = dryrun.run_ranks(2, "tinympc_julia_tpu_torch.dryrun:leg_sharded",
                             device="cuda", out_dir=tmp_path, timeout=600)
    for path in paths:
        out = np.load(path)
        assert out["l1_iter"].shape == (2,) and out["l1_seconds_vote1"] > 0


# -- the lifted shapes: wide maps, wide stages, many cones, long horizons ----

def _quad(horizon, dev, ub=0.5, x_bound=None, dtype=torch.float32):
    kw = {}
    if x_bound is not None:
        xb = np.tile(np.full(12, x_bound), (horizon, 1))
        kw = dict(x_min=-xb, x_max=xb)
    p = make_problem(quadrotor.A, quadrotor.B, np.diag(quadrotor.Q_DIAG),
                     np.diag(quadrotor.R_DIAG), quadrotor.RHO, horizon,
                     u_min=-ub, u_max=ub, dtype=dtype, device=dev, **kw)
    return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)


def chain_plant(n=10, dt=0.5):
    """A chain of ``n`` unit masses in a line, unit springs between
    neighbours and to the two walls, the n - 1 inputs the tensions between
    neighbours; state (positions, velocities), zero-order hold at ``dt``.
    Returns (A (2n, 2n), B (2n, n - 1))."""
    from scipy.linalg import expm
    lap = 2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1)
    tension = np.eye(n, n - 1) - np.eye(n, n - 1, k=-1)
    m = np.zeros((3 * n - 1, 3 * n - 1))
    m[:n, n:2 * n] = np.eye(n)
    m[n:2 * n, :n] = -lap
    m[n:2 * n, 2 * n:] = tension
    e = expm(m * dt)
    return e[:2 * n, :2 * n], e[:2 * n, 2 * n:]


def _chain(horizon, dev, ub=1.0, x_bound=None):
    A, B = chain_plant()
    kw = {}
    if x_bound is not None:
        kw = dict(x_min=np.full((horizon, 20), -x_bound),
                  x_max=np.full((horizon, 20), x_bound))
    p = make_problem(A, B, np.eye(20), np.eye(9), 1.0, horizon, u_min=-ub,
                     u_max=ub, dtype=torch.float32, device=dev, **kw)
    return p, precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)


def _chain_x0(B, seed, dev):
    return torch.as_tensor(0.5 * np.random.default_rng(seed).standard_normal(
        (B, 20)), dtype=torch.float32, device=dev)


@pytest.mark.parametrize("horizon,kw", [
    (110, dict(max_iter=100)),
    (110, dict(max_iter=100, bf16_head_iters=32, check_termination=4)),
    (200, dict(max_iter=60)),
    (200, dict(max_iter=60, bf16_head_iters=16, check_termination=4)),
], ids=["n110-fp32", "n110-head32", "n200-fp32", "n200-head16"])
def test_wide_map_layouts_match_plain_version(dev, horizon, kw):
    """K1 on maps too wide for a tile's w2 in shared memory: the quadrotor
    at N = 110 (sw 1,756) and N = 200 (sw 3,196), the tile split over a
    thread block cluster, each block a slice of whole stages with its rows
    of w2 in its shared memory; fp32 and with a reduced head; the carry
    too."""
    p, c = _quad(horizon, dev)
    reduced = "bf16_head_iters" in kw
    plan = K.fused_tile_plan(12, 4, horizon, reduced)
    assert plan.tile == 32 and plan.cluster > 1 and not plan.w2_global
    x0 = _x0(300, 12, 3, 0.3, dev)  # a ragged last tile
    args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max, p.x_min,
            p.x_max, x0, None)
    full = _kw(12, 4, N=horizon, relaxation_alpha=1.7, **kw)
    before = K.condensed_fused_cuda.launches
    k = K.condensed_fused_cuda(*args, **full)
    r = K.condensed_fused_reference(*args, **full)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.launches == before + 1
    _counts_and_values_agree(k, r)
    same = k[2] == r[2]
    for a, b in zip(k[4], r[4]):
        assert ((a - b)[:, same].abs()
                / b[:, same].abs().clamp(min=1.0)).max().item() <= 1e-4


@pytest.mark.parametrize("horizon", [110, 200], ids=["n110", "n200"])
def test_wide_map_warm_chain_and_groups(dev, horizon):
    """The wide layouts' carry (K1b: two chained launches equal one, bit for
    bit) and group grid (K1d: two groups of their own rho and bound)."""
    p, c = _quad(horizon, dev)
    m = build_condensed(p, c)
    args = (m, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
            _x0(100, 12, 4, 0.3, dev))
    kw = dict(N=horizon, relaxation_alpha=1.7)
    one = K.condensed_fused_cuda(*args, **_kw(12, 4, max_iter=60,
                                              carry_out=False, **kw))
    a = K.condensed_fused_cuda(*args, **_kw(12, 4, max_iter=20, **kw))
    b = K.condensed_fused_cuda(*args, a[4], **_kw(
        12, 4, max_iter=40, warm_start=True, carry_out=False, **kw))
    done = a[3] == 1
    assert torch.equal(torch.where(done, a[2], 20 + b[2]), one[2])
    assert torch.equal(torch.where(done[:, None, None], a[1], b[1]), one[1])
    G = 2
    mg = type(m)(*(t.expand((G,) + t.shape).contiguous() for t in m))
    rho = torch.tensor([float(c.rho), float(c.rho)], device=dev)
    um = torch.stack([p.u_min.reshape(-1), 0.8 * p.u_min.reshape(-1)])
    x0 = _x0(G * 70, 12, 5, 0.3, dev).reshape(G, 70, 12)
    gargs = (mg, rho, um, -um, p.x_min.reshape(-1), p.x_max.reshape(-1), x0,
             None)
    full = _kw(12, 4, max_iter=60, **kw)
    k = K.condensed_fused_cuda(*gargs, num_groups=G, **full)
    r = K.condensed_fused_reference(*gargs, num_groups=G, **full)
    torch.cuda.synchronize()
    _counts_and_values_agree(k, r)


def test_wide_stages_and_many_cones_match_plain_version(dev):
    """K1e on the 20-state chain: a state stage of 20 entries with 10 cones
    of dim 2 (mu 0.5), 4 halfspace rows and the state box, beside a
    projected input side (one cone over the 9 tensions)."""
    Nc = 8
    p, c = _chain(Nc, dev, x_bound=3.0)
    rng = np.random.default_rng(11)
    cons = dict(soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
                lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)),
                soc_u=((0, 9, 2.0),))
    fn_kw = dict(max_iter=60, en_state_bound=True, relaxation_alpha=1.7,
                 carry_out=True)
    fk = K.make_condensed_fused_solver(20, 9, Nc, **fn_kw, **cons)
    args = (build_condensed(p, c), float(c.rho), p.u_min.reshape(-1),
            p.u_max.reshape(-1), p.x_min.reshape(-1), p.x_max.reshape(-1),
            _chain_x0(500, 12, dev))
    before = K.condensed_fused_cuda.projected_launches
    k = fk(*args)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.projected_launches == before + 1
    cons_t = K.fused_constraints(**cons, nx=20, nu=9, dtype=torch.float32,
                                 device=dev)
    r = K.condensed_fused_reference(
        *args, constraints=cons_t, nx=20, nu=9, N=Nc, abs_pri_tol=1e-3,
        abs_dua_tol=1e-3, en_input_bound=True, check_termination=1,
        warm_start=False, **fn_kw)
    _counts_and_values_agree(k, r)


def _wide64(dev):
    """A made-up stable plant of 64 states and 2 inputs at N = 3, |x| <= 2,
    with 16 state cones of dim 4 (mu 0.5) and 3 halfspace rows: a stage
    wider than the widest register width, projected in memory."""
    rng = np.random.default_rng(3)
    A = 0.9 * np.eye(64) + rng.normal(scale=0.005, size=(64, 64))
    p = make_problem(A, rng.normal(scale=0.1, size=(64, 2)), np.eye(64),
                     np.eye(2), 1.0, 3, u_min=-1.0, u_max=1.0,
                     x_min=np.full((3, 64), -2.0), x_max=np.full((3, 64), 2.0),
                     dtype=torch.float32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    cons = dict(soc_x=tuple((4 * j, 4, 0.5) for j in range(16)),
                lin_x=(np.ones((3, 64)), np.ones(3)))
    x0 = torch.as_tensor(np.random.default_rng(4).uniform(-1, 1, (300, 64)),
                         dtype=torch.float32, device=dev)
    return p, c, cons, x0


@pytest.mark.parametrize("alpha", [1.0, 1.7], ids=["alpha1", "alpha1.7"])
@pytest.mark.parametrize("ct", [1, 4], ids=["ct1", "ct4"])
@pytest.mark.parametrize("case", ["chain", "rocket", "wide64", "grouped"])
def test_k1e_stage_buffers_agree_bit_for_bit(dev, monkeypatch, case, ct,
                                             alpha):
    """K1e projects each stage once an iteration, in a buffer of each
    thread's own in shared memory where it fits and in the lanes' rows of a
    global scratch where it does not, in one pass that also takes its
    residuals.  The 20-state chain (10 state cones, 4 halfspace rows, an
    input cone), the rocket (its input and state cones: lanes latch and
    write the carry), a stage of 64 entries with 16 cones and the chain's
    group grid (two groups, per-group cone mu and halfspace rows), at ct 1
    and 4 and alpha 1 and 1.7: the buffers and the global scratch forced
    give the same bits, carry included, and the plain version's counts and
    values."""
    G = 1
    if case == "wide64":
        p, c, cons_kw, x0 = _wide64(dev)
        nx, nu, Nc = 64, 2, 3
        cons = K.fused_constraints(**cons_kw, nx=nx, nu=nu,
                                   dtype=torch.float32, device=dev)
        args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max,
                p.x_min, p.x_max, x0, None)
        kw = _kw(nx, nu, N=Nc, max_iter=60, en_state_bound=True,
                 constraints=cons)
        agree = _counts_and_values_agree
    else:
        nx, nu, Nc, args, kw, agree = _k1e_case(
            "rocket" if case == "rocket" else "chain", dev,
            grouped=case == "grouped")
        G = kw.get("num_groups", 1)
    kw = dict(kw, check_termination=ct, relaxation_alpha=alpha,
              max_iter=kw["max_iter"] // ct * ct)
    plan = K.fused_tile_plan(nx, nu, Nc, state_free=False, projected=True)
    assert K.launch_smem(plan, nx, nu)[1]
    own = K.condensed_fused_cuda(*args, **kw)
    monkeypatch.setattr(K, "launch_smem",
                        lambda plan, *dims: (plan.smem, False))
    scratch = K.condensed_fused_cuda(*args, **kw)
    r = K.condensed_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(own[:4], scratch[:4]):
        assert torch.equal(a, b)
    for a, b in zip(own[4], scratch[4]):
        assert torch.equal(a, b)
    if case == "rocket":
        assert int(own[3].sum()) > 0  # lanes latch and freeze their carry
    if G > 1:
        agree = _counts_and_values_agree
    agree(own, r)


@pytest.mark.parametrize("horizon,kw", [
    (150, {}), (150, dict(precision="default", check_termination=5,
                          max_iter=5)),
], ids=["fp32", "default"])
def test_adaptive_global_iterates_match_plain_version(dev, horizon, kw):
    """K2 on the quadrotor at N = 150 (sw 2,396): the iterates of a tile of
    16 lanes leave no room, so a tile of 32 splits over a thread block
    cluster, each block with its slices of vec1 and ux in its shared
    memory.
    Reduced: four bf16 iterations from the cold start
    (the plain version sums them as the tensor cores do) and one fp32
    check; later reduced iterations would round the cuBLAS-ordered fp32
    products of 2,397 columns to bf16 and part from the kernel's."""
    p, c = _quad(horizon, dev)
    plan = K2.adaptive_tile_plan(12, 4, horizon, 2, "precision" in kw)
    assert plan.tile == 32 and plan.cluster > 1 and not plan.iterates_global
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(200, 12, 6, 0.3, dev), None)
    full = _k2_kw(p, c, **dict(_QUAD_KW, **dict(dict(max_iter=150), **kw)))
    before = K2.condensed_adaptive_cuda.launches
    k = K2.condensed_adaptive_cuda(*args, **full)
    r = K2.condensed_adaptive_reference(*args, **full)
    torch.cuda.synchronize()
    assert K2.condensed_adaptive_cuda.launches == before + 1
    _counts_and_values_agree(k, r)


def test_adaptive_osqp_controller_on_a_wide_stage(dev):
    """K2's OSQP-form controller on the 20-state chain (stages of 20 and 9
    entries), its new slacks and duals in the global scratch."""
    p, c = _chain(20, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _chain_x0(300, 13, dev), None)
    full = _k2_kw(p, c, max_iter=150, adaptive_rho_min=0.2,
                  adaptive_rho_max=5.0)
    k = K2.condensed_adaptive_cuda(*args, **full)
    r = K2.condensed_adaptive_reference(*args, **full)
    torch.cuda.synchronize()
    _k2_agree(k, r)
    assert bool((k[4] != 1.0).any())  # the controller moved rho


@pytest.mark.parametrize("case", ["chain-wide", "chain-wide-state-box",
                                  "quadrotor-far", "quadrotor-far-box",
                                  "cartpole-far-stage-box",
                                  "wide-far-matrices"])
def test_stage_kernel_lifted_shapes(dev, case):
    """K3's wide variant on the 20-state chain (lane groups of 8, the stage
    vectors in shared memory) and its far layout on the quadrotor at N = 300
    (the workspace in global memory), with and without a state box; the
    per-stage terms in global memory too (the cartpole at N = 4,000 with a
    state box, two iterations); the wide variant reading its matrices from
    the caller's tensors (a made-up 96 x 96 plant)."""
    box = "box" in case
    budget, batch = 200, 1001
    if case.startswith("chain"):
        p, c = _chain(20, dev, x_bound=0.6 if box else None)
        x0 = _chain_x0(batch, 14, dev)
        if box:
            x0 = x0.clamp(-0.5, 0.5)
    elif case.startswith("quadrotor"):
        # 4,096 lanes: at 1,001 the plain version's cuBLAS products of
        # (12, 12) by (12, 1001) sum in another order and, under the state
        # box over 300 stages, move ~9% of the lanes' latches by one or two
        # iterations; at 4,096 the two agree on every count
        batch = 4096
        p, c = _quad(300, dev, x_bound=2.0 if box else None)
        x0 = _x0(batch, 12, 15, 0.3, dev)
    elif case.startswith("cartpole"):
        horizon, budget, batch = 4000, 2, 300
        xb = np.tile([2.0, 1e17, 1e17, 1e17], (horizon, 1))
        p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                         np.diag(cartpole.R_DIAG), cartpole.RHO, horizon,
                         u_min=-5.0, u_max=5.0, x_min=-xb, x_max=xb,
                         dtype=torch.float32, device=dev)
        c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
        x0 = _x0(batch, 4, 16, 0.5, dev)
    else:
        rng = np.random.default_rng(17)
        n, budget, batch = 96, 30, 64
        p = make_problem(np.eye(n) + rng.normal(size=(n, n)) * 0.01 / 10,
                         rng.normal(size=(n, n)) * 0.1, np.eye(n), np.eye(n),
                         1.0, 4, u_min=-1.0, u_max=1.0, dtype=torch.float32,
                         device=dev)
        c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
        x0 = _x0(batch, n, 17, 0.1, dev)
    full = dict(nx=p.nx, nu=p.nu, N=p.N, max_iter=budget, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=box, en_input_bound=True,
                check_termination=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = K3.fused_stage_plan(p.nx, p.nu, p.N, box, batch, sms)
    expect = {"chain": (False, False, False), "quadrotor": (True, False, False),
              "cartpole": (True, True, False), "wide": (True, False, True)}
    assert (plan.workspace_global, plan.stage_global,
            plan.matrices_global) == expect[case.split("-")[0]]
    before = K3.fused_cuda.launches
    k = K3.fused_cuda(*_k3_args(p, c, x0), **full)
    r = K3.fused_reference(*_k3_args(p, c, x0), **full)
    torch.cuda.synchronize()
    assert K3.fused_cuda.launches == before + 1
    _counts_and_values_agree(k, r)
    if budget > 2:
        assert int((k[3] == 1).sum()) > batch // 2


def _forced(monkeypatch, module, name, plan):
    """Make ``module``'s wrapper launch ``plan`` whatever the shape."""
    monkeypatch.setattr(module, name, lambda *a, **k: plan)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _streamed_case(model, horizon, dev):
    """A plant at a width whose maps stream in one pass on the continuation
    layouts: (problem, cache, constraints or None, x0s(B, seed), K2's rho
    settings).  The quadrotor (|u| <= 0.5), the cartpole (|u| <= 5) and the
    rocket with its cones and state box."""
    if model == "rocket":
        s = rocket.make_solver(N=horizon, dtype=torch.float32, device=dev)
        Xref, Uref = rocket.reference_trajectory(0, N=horizon)
        s.set_x_ref(Xref)
        s.set_u_ref(Uref)
        p, c = s.problem, s.cache
        cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                                   nx=6, nu=3, dtype=torch.float32,
                                   device=dev)
        return (p, c, cons, lambda B, seed: _rocket_x0(B, dev),
                dict(controller="termination", taylor_trust=2.0,
                     adaptive_rho_min=1.0, adaptive_rho_max=1e3))
    if model == "quadrotor":
        p, c = _quad(horizon, dev)
        return (p, c, None, lambda B, seed: _x0(B, 12, seed, 0.3, dev),
                _QUAD_KW)
    p = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                     np.diag(cartpole.R_DIAG), cartpole.RHO, horizon,
                     u_min=-5.0, u_max=5.0, dtype=torch.float32, device=dev)
    c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    return (p, c, None, lambda B, seed: _x0(B, 4, seed, 0.5, dev),
            dict(controller="termination", taylor_trust=2.0,
                 adaptive_rho_min=1.0, adaptive_rho_max=1e3))


@pytest.mark.parametrize("slots", [2048, 2040], ids=["2048", "partial"])
@pytest.mark.parametrize("order", [2, 4], ids=["order2", "order4"])
@pytest.mark.parametrize("controller", ["termination", "osqp"])
@pytest.mark.parametrize("model,horizon", [
    ("quadrotor", 20), ("quadrotor", 32), ("cartpole", 80), ("rocket", 40)],
    ids=["quadrotor20", "quadrotor32", "cartpole80", "rocket40"])
def test_k2_continuation_layout_agrees_bit_for_bit(dev, monkeypatch, model,
                                                   horizon, controller,
                                                   order, slots):
    """K2's warm continuation at the adaptive quadrotor's 2,048 slots (and
    2,040: a last tile of 8 of its 16 lanes) takes the continuation layout
    (tiles of 16 lanes, one pass each product, slabs by the bulk copy
    engine, a checking iteration's box passes in one; forced at the
    other widths, whatever the plan takes there): the same bits as
    the tiles of 32 it replaced, forced, carry included, under the
    termination and the OSQP-form controller at Taylor order 2 and 4; the
    same bits as the plain version under the termination controller, and
    under the OSQP-form one K2's bar against its plain version
    (``_k2_agree``: the plain OSQP-form residuals are batched matmuls on
    the card, not sums in index order).  At the quadrotor's N = 20 (sw
    316) and 32 (sw 508: the forward map's padded rows fill the pass), the
    cartpole's N = 80 (sw 399) and the rocket's N = 40 (sw 357, its cones
    projected; no lane latches within the budget there, so every lane runs
    every iteration).  At the cartpole's width the plain version's
    products, matmuls on the card, do not sum in index order under either
    controller (the two layouts agree bit for bit and the plain version
    differs from both), so there K2's bar holds it."""
    p, c, cons, x0s, rho_kw = _streamed_case(model, horizon, dev)
    nx, nu = p.nx, p.nu
    tm = build_condensed_taylor(p, c, order=order)
    args = (tm, p.u_min, p.u_max, p.x_min, p.x_max, x0s(slots, 23))
    rho = rho_kw if controller == "termination" else dict(
        controller="osqp", adaptive_rho_min=1.0, adaptive_rho_max=50.0)
    kw = _k2_kw(p, c, max_iter=30, constraints=cons,
                en_state_bound=cons is not None, **rho)
    bulk = K2.condensed_adaptive_cuda(*args, None, **kw)
    kw = dict(kw, max_iter=300, warm_start=True)
    free = cons is None
    plan = K2.continuation_adaptive_plan(nx, nu, horizon, order, False, free)
    assert (plan.tile, plan.passes1, plan.passes2, plan.bulk_ring) == (
        16, 1, 1, True)
    if (model, horizon) == ("quadrotor", N):  # the pipeline's plan
        assert plan == K2.adaptive_tile_plan(
            nx, nu, horizon, order, False, free, tiles=-(-slots // 32),
            sms=_sms(dev))
    else:
        _forced(monkeypatch, K2, "adaptive_tile_plan", plan)
    k = K2.condensed_adaptive_cuda(*args, bulk[5], **kw)
    r = K2.condensed_adaptive_reference(*args, bulk[5], **kw)
    _forced(monkeypatch, K2, "adaptive_tile_plan",
            K2.shared_adaptive_plan(nx, nu, horizon, order, False, free))
    o = K2.condensed_adaptive_cuda(*args, bulk[5], **kw)
    torch.cuda.synchronize()
    assert same_bits(k, o)
    if controller == "termination":
        assert model == "rocket" or int(k[3].sum()) > slots // 2
    if controller == "termination" and model != "cartpole":
        assert same_bits(k, r)
    else:
        _k2_agree(k, r)


@pytest.mark.parametrize("case", ["bulk", "ragged", "grid", "default",
                                  "osqp", "rocket", "cartpole", "chain-osqp",
                                  "quad-n21", "quad-n40", "widest"])
def test_k2_four_lane_layout_agrees_bit_for_bit(dev, monkeypatch, case):
    """K2's tiles of 32 lanes on the 4-lane layout (10 rows x 4 lanes a
    thread in the forward product, 12 x 4 in the backward, slabs of 16
    k-rows by the bulk copy engine, the maps' rows padded to the threads'
    rows): the same bits as 2 lanes a thread (the layout it replaced,
    forced), carry included; the same bits as the plain version under the
    termination controller where the plain products sum in index order
    (the quadrotor's and the rocket's single problem), else K2's bar
    against it (``_k2_agree``).  bulk: the adaptive pipeline's bulk pass
    (the quadrotor at N = 20, the termination controller with trust 2,
    150 iterations, the carry out, staged in shared memory so that a
    checking iteration's box step takes one pass) at 8,192 lanes, on the
    plan's layout;
    ragged: 4,100 lanes (a last tile of 4) without the carry out (the
    one-pass box step), the plan's; grid: 3 randomised quadrotors x 1,000
    lanes (per-group maps, rho0 and bounds, ragged tiles), the plan's;
    default: ``precision="default"`` at ct = 5 (the bf16 iterations keep
    the tensor-core product; the carry not staged, no room: two passes);
    osqp: the OSQP-form controller (these two held to the plain version
    on their outputs, the bar of the reduced quadrotor's tiles of 16, and
    bit for bit to 2 lanes, carry included); rocket: the
    rocket at N = 27 (sw 240, 4 su 312) with its cones and state box, the
    projected stages; cartpole: the cartpole at N = 52 (sw 259).  Those
    four forced onto the layout at 2,200 lanes.  In passes (the maps laid
    out pass by pass, passes of 320 rows in the forward product and of 384
    in the backward): chain-osqp, the 20-state chain under the OSQP-form
    controller (phase 35b's settings at 2,200 lanes with the carry out: 2 +
    2 passes, the state in global memory; held to the plain version by
    K2's bar); quad-n21
    and quad-n40, the quadrotor at N = 21 (2 + 1 passes, the backward's 324
    rows a slot wider than the forward's 320) and 40 (2 + 2) under the
    termination controller with the carry out, at 8,192 lanes on the plan's
    layout; widest, the quadrotor at N = 56 (sw 892, 3 + 3 passes: the
    widest the layout takes), the same, at 4,096 lanes."""
    G, nx, nu = 1, 12, 4
    if case == "chain-osqp":
        horizon, nx, nu = N, 20, 9
        p, c = _chain(horizon, dev)
        tm = build_condensed_taylor(p, c)
        x0 = _chain_x0(2200, 37, dev)
        kw = _k2_kw(p, c, max_iter=150, adaptive_rho_min=0.2,
                    adaptive_rho_max=5.0)
    elif case in ("quad-n21", "quad-n40", "widest"):
        horizon = dict(zip(("quad-n21", "quad-n40", "widest"),
                           (21, 40, 56)))[case]
        p, c = _quad(horizon, dev)
        tm = build_condensed_taylor(p, c)
        x0 = _x0(4096 if case == "widest" else 8192, 12, 33, 0.3, dev)
        kw = _k2_kw(p, c, max_iter=150, **_QUAD_KW)
    elif case in ("rocket", "cartpole"):
        model, horizon = case, 27 if case == "rocket" else 52
        p, c, cons, x0s, rho_kw = _streamed_case(model, horizon, dev)
        tm = build_condensed_taylor(p, c)
        x0 = x0s(2200, 41)
        kw = _k2_kw(p, c, max_iter=150, constraints=cons,
                    en_state_bound=cons is not None, **rho_kw)
        nx, nu = p.nx, p.nu
    elif case == "grid":
        G, horizon = 3, N
        p, c = _groups(quadrotor, G, dev, ub_range=(0.4, 0.6), seed=5)
        tm = build_condensed_taylor(p, c)
        x0 = _gx0(G, 1000, 12, 6, 0.3, dev)
        kw = dict(plant=None, nx=12, nu=4, N=N, max_iter=150,
                  abs_pri_tol=1e-3, abs_dua_tol=1e-3, en_state_bound=False,
                  en_input_bound=True, relaxation_alpha=1.0,
                  adaptive_rho_min=quadrotor.RHO * 0.8,
                  adaptive_rho_max=1e3, adaptive_rho_clipping=True,
                  check_termination=1, controller="termination",
                  taylor_trust=2.0, warm_start=False, carry_out=True,
                  num_groups=G)
    else:
        horizon = N
        p, c = _quad(N, dev)
        tm = build_condensed_taylor(p, c)
        B = dict(bulk=8192, ragged=4100).get(case, 2200)
        x0 = _x0(B, 12, 31, 0.3, dev)
        rho = (dict(controller="osqp", adaptive_rho_min=1.0,
                    adaptive_rho_max=50.0) if case == "osqp" else _QUAD_KW)
        kw = _k2_kw(p, c, max_iter=150, **rho)
        if case == "ragged":
            kw["carry_out"] = False
        if case == "default":
            kw.update(check_termination=5, precision="default")
    free = kw.get("constraints") is None
    reduced = case == "default"
    four = K2.four_lane_adaptive_plan(nx, nu, horizon, 2, reduced, free)
    su, sw = (horizon - 1) * nu, (horizon - 1) * nu + horizon * nx
    passes = dict(zip(("chain-osqp", "quad-n21", "quad-n40", "widest"),
                      ((2, 2), (2, 1), (2, 2), (3, 3)))).get(case, (1, 1))
    assert (four.tile, four.lanes, four.passes1, four.passes2) == (
        32, 4) + passes
    assert four.bulk_ring and four.ld == K2.bulk_ld(
        su, sw, 20, None if passes == (1, 1) else 320)
    if case in ("bulk", "ragged", "grid", "quad-n21", "quad-n40",
                "widest"):  # the plan's at this batch
        assert four == K2.adaptive_tile_plan(
            nx, nu, horizon, 2, reduced, free,
            tiles=G * -(-(x0.numel() // nx // G) // 32), sms=_sms(dev))
    else:
        _forced(monkeypatch, K2, "adaptive_tile_plan", four)
    args = (tm, p.u_min, p.u_max, p.x_min, p.x_max, x0, None)
    before = K2.condensed_adaptive_cuda.launches
    k = K2.condensed_adaptive_cuda(*args, **kw)
    assert K2.condensed_adaptive_cuda.launches == before + 1
    r = K2.condensed_adaptive_reference(*args, **kw)
    _forced(monkeypatch, K2, "adaptive_tile_plan",
            K2.shared_adaptive_plan(nx, nu, horizon, 2, reduced, free))
    o = K2.condensed_adaptive_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert same_bits(k, o)
    # no rocket lane latches within the budget, nor any lane at ct = 5
    # under bf16 noise (a true fp32 check fails on the reduced iterates:
    # ROADMAP R8); under the OSQP-form controller fewer than half latch
    if case not in ("rocket", "default", "chain-osqp"):
        solved = int(k[3].sum())
        assert solved > (0 if case == "osqp" else k[2].numel() // 2)
    if case in ("bulk", "ragged", "rocket", "quad-n21", "quad-n40",
                "widest"):
        assert same_bits(k, r)
    elif case in ("grid", "cartpole", "chain-osqp"):
        if case == "chain-osqp":
            assert bool((k[4] != 1.0).any())  # the controller moved rho
        _k2_agree(k, r)
    else:
        # the plain OSQP-form residuals (batched matmuls) and bf16 products
        # do not sum as the kernel does: counts and flags on >= 99% of
        # lanes, x, u and rho within 1e-4 on the lanes that both solved
        # with equal counts (the bar of the reduced quadrotor's tiles of 16)
        same = (k[2] == r[2]) & (k[3] == r[3])
        assert same.float().mean().item() >= 0.99
        both = same & (k[3] == 1) & (r[3] == 1)
        assert case == "default" or bool(both.any())
        if bool(both.any()):
            for j in (0, 1):
                assert (k[j] - r[j])[both].abs().max().item() <= 1e-4
            assert ((k[4] - r[4]).abs() / r[4])[both].max().item() <= 1e-4


@pytest.mark.parametrize("slots", [2048, 2040], ids=["2048", "partial"])
@pytest.mark.parametrize("head", [0, 64], ids=["fp32", "head64"])
@pytest.mark.parametrize("model,horizon", [
    ("quadrotor", 20), ("cartpole", 64), ("rocket", 35)],
    ids=["quadrotor20", "cartpole64", "rocket35"])
def test_k1d_continuation_layout_agrees_bit_for_bit(dev, monkeypatch, model,
                                                    horizon, head, slots):
    """K1d's grouped warm continuation at the requantized pipeline's 3
    buckets x 2,048 slots (and 2,040) on the 4-lane layout (10 rows x 4
    lanes a thread in the fp32 product, slabs of 16 k-rows by the bulk copy
    engine, a checking iteration's box passes in one; the plan's at the
    quadrotor's N = 20, forced at the other widths), with and without a
    reduced head: the same bits as the plain version and as 2 lanes a
    thread, forced, carry included.  At the quadrotor's N = 20 (sw 316),
    the cartpole's N = 64 (sw 319) and the rocket's N = 35 (sw 312, its
    cones projected; no lane latches within the budget there)."""
    from tinympc_julia_tpu_torch.parallel.pipeline import requantized_buckets
    p, c, cons, x0s, _ = _streamed_case(model, horizon, dev)
    nx, nu = p.nx, p.nu
    rhos, bmaps = requantized_buckets(p, c)
    G = len(rhos)
    brho = torch.tensor(rhos, dtype=torch.float32, device=dev)
    args = (bmaps, brho, p.u_min, p.u_max, p.x_min, p.x_max,
            x0s(G * slots, 24))
    kw = dict(nx=nx, nu=nu, N=horizon, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
              en_state_bound=cons is not None, en_input_bound=True,
              relaxation_alpha=1.0, check_termination=1, num_groups=G,
              carry_out=True, constraints=cons)
    cold = K.condensed_fused_cuda(*args, None, max_iter=30,
                                  warm_start=False, **kw)
    kw = dict(kw, max_iter=300, warm_start=True, bf16_head_iters=head)
    two = K.shared_tile_plan(nx, nu, horizon, head > 0, cons is None)
    assert (two.lanes, two.passes, two.rpt, two.resident) == (2, 1, 20,
                                                              False)
    if (model, horizon) == ("quadrotor", N):  # the pipeline's plan
        assert K.fused_tile_plan(nx, nu, horizon, head > 0,
                                 cons is None) == two._replace(lanes=4)
    else:
        _forced(monkeypatch, K, "fused_tile_plan", two._replace(lanes=4))
    k = K.condensed_fused_cuda(*args, cold[4], **kw)
    r = K.condensed_fused_reference(*args, cold[4], **kw)
    _forced(monkeypatch, K, "fused_tile_plan", two)
    o = K.condensed_fused_cuda(*args, cold[4], **kw)
    torch.cuda.synchronize()
    assert model == "rocket" or int(k[3].sum()) > G * slots // 2
    assert same_bits(k, o)
    assert same_bits(k, r)


def _agree_as_float32(k, r, r64, lanes):
    """The kernel (``k``) as close to the plain version in float64
    (``r64``) as the plain version in float32 (``r``) is: the lanes whose
    counts or flags differ from float64's no more than the float32 plain
    version's, give or take ``lanes`` (which of the lanes on the tolerance
    move depends on the sum order, so two float32 orders move about as
    many, not the same ones); and ``_agree``'s values against the float32
    plain version, whose maps are the kernel's (the float64 maps move the
    solution itself by ~1e-4): more than half the lanes solved with equal
    counts on both, their controls and states within 1e-4."""
    def differ(a):
        return int(((a[2] != r64[2]) | (a[3] != r64[3])).sum())
    assert differ(k) <= differ(r) + lanes
    both = (k[2] == r[2]) & (k[3] == 1) & (r[3] == 1)
    assert int(both.sum()) > k[2].numel() // 2
    for j in (0, 1):
        assert (k[j] - r[j]).abs()[both].max().item() <= 1e-4


@pytest.mark.parametrize("case", ["quad-n40", "quad-n40-state-box",
                                  "quad-n40-state-box-ct1", "widest",
                                  "chain-k1e", "grid", "warm-chain", "carry",
                                  "head"])
def test_k1_four_lane_multi_pass_agrees_bit_for_bit(dev, monkeypatch, case):
    """K1's 4-lane layout in passes (10 rows x 4 lanes a thread, passes of
    320 rows, the map laid out pass by pass, slabs of 16 k-rows of a pass
    by the bulk copy engine, the first passes' sums parked): the same bits
    as 2 lanes a thread (the layout it replaced, forced), carry included,
    and the plain version's bar.  The quadrotor at N = 40 (sw 636, 2
    passes, the last of 316 rows) without a state box and with |x| <= 2;
    widest, N = 56 (sw 892, 3 passes); chain-k1e, the 20-state chain at
    N = 20 with phase 36's 10
    state cones, 4 halfspace rows and state box (sw 571; the lanes do not
    converge: counts and values); grid, K1d over 4 randomised quadrotors
    at N = 40 x 300 lanes (ragged tiles); warm-chain, K1b: a 30-iteration
    launch with its carry and a 50-iteration warm one equal the
    80-iteration launch; carry, 8 lanes at the origin that latch on the
    cold launch's first checking iteration keep the w2 and slacks they
    started from (F11), as the plain version's carry does; head, K1c's
    8-iteration reduced head (the bf16 map row-major, its last pass's
    valid rows streamed) then fp32.  The quadrotor's cases check every 4
    iterations, as phase 4w does, but carry, warm-chain and
    quad-n40-state-box-ct1 (every one).  With the state box and a check
    every iteration the plain version's cuBLAS product (not in index
    order at 636 rows) moves about 1% of the lanes' counts by one against
    every index-order layout of the kernel (23 of 2,048 lanes on an H100,
    ``layout_probe order``, PERF.md section 6), so that case holds the
    kernel's counts to the plain version in float64 instead: no farther
    from it than the float32 plain version, give or take 0.5% of the
    lanes (``_agree_as_float32``; measured 38 lanes against 37)."""
    G, horizon, nx, nu, agree = 1, 40, 12, 4, _agree
    cons = None
    if case == "chain-k1e":
        horizon, nx, nu = N, 20, 9
        p, c = _chain(horizon, dev, x_bound=3.0)
        rng = np.random.default_rng(11)
        cons = K.fused_constraints(
            soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
            lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)), nx=20, nu=9,
            dtype=torch.float32, device=dev)
        x0 = _chain_x0(1000, 38, dev)
        kw = _kw(nx, nu, N=horizon, max_iter=100, relaxation_alpha=1.0,
                 en_state_bound=True, constraints=cons)
        agree = _counts_and_values_agree
    elif case == "grid":
        G = 4
        p, c = _groups(quadrotor, G, dev, ub_range=(0.4, 0.6), seed=5,
                       horizon=horizon)
        x0 = _gx0(G, 300, 12, 6, 0.3, dev)
        kw = _kw(12, 4, N=horizon, max_iter=200, check_termination=4,
                 num_groups=G)
    else:
        horizon = 56 if case == "widest" else horizon
        box = case.startswith("quad-n40-state-box")
        p, c = _quad(horizon, dev, x_bound=2.0 if box else None)
        x0 = _x0(2048, 12, 33, 0.3, dev)
        if case == "carry":
            x0[:8] = 0.0
        # phase 4w's check every 4 iterations, but where a lane must latch
        # on the cold iteration 0, the chain's 30 + 50 and the state box's
        # check every iteration
        every = case in ("carry", "warm-chain", "quad-n40-state-box-ct1")
        kw = _kw(12, 4, N=horizon, max_iter=200, en_state_bound=box,
                 check_termination=1 if every else 4,
                 **(dict(bf16_head_iters=8) if case == "head" else {}))
        if case == "quad-n40-state-box-ct1":
            p64, c64 = _quad(horizon, dev, x_bound=2.0, dtype=torch.float64)
            r64 = K.condensed_fused_reference(
                build_condensed(p64, c64), float(c64.rho), p64.u_min,
                p64.u_max, p64.x_min, p64.x_max, x0.double(), None, **kw)

            def agree(k, r):
                _agree_as_float32(k, r, r64, x0.shape[0] // 200)
    reduced = case == "head"
    free = not kw["en_state_bound"] and cons is None
    sw = (horizon - 1) * nu + horizon * nx
    four = K.four_lane_tile_plan(nx, nu, horizon, reduced, free)
    assert (four.lanes, four.rpt, four.passes, four.resident) == (
        4, 20, 3 if case == "widest" else 2, False)
    assert four.rows == K.pass_rows(sw, 10, 320) <= four.passes * 320
    assert K.fused_tile_plan(nx, nu, horizon, reduced, free,
                             projected=cons is not None, groups=G) == four
    args = (build_condensed(p, c), c.rho if G > 1 else float(c.rho),
            p.u_min, p.u_max, p.x_min, p.x_max, x0)
    if case == "warm-chain":
        one = K.condensed_fused_cuda(*args, None,
                                     **dict(kw, max_iter=80, carry_out=False))
        first = K.condensed_fused_cuda(*args, None, **dict(kw, max_iter=30))
        args = args + (first[4],)
        kw = dict(kw, max_iter=50, warm_start=True, carry_out=False)
    else:
        args = args + (None,)
    before = K.condensed_fused_cuda.launches
    k = K.condensed_fused_cuda(*args, **kw)
    assert K.condensed_fused_cuda.launches == before + 1
    r = K.condensed_fused_reference(*args, **kw)
    _forced(monkeypatch, K, "fused_tile_plan",
            K.shared_tile_plan(nx, nu, horizon, reduced, free))
    o = K.condensed_fused_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert same_bits(k, o)
    agree(k, r)
    if case == "warm-chain":
        done = first[3] == 1
        assert torch.equal(torch.where(done, first[2], 30 + k[2]), one[2])
        assert torch.equal(torch.maximum(first[3], k[3]), one[3])
        for j in (0, 1):
            assert torch.equal(torch.where(done[:, None, None], first[j],
                                           k[j]), one[j])
    if case == "carry":
        assert (k[2][:8] == 1).all() and (r[2][:8] == 1).all()
        for a, b in zip(k[4], r[4]):  # the carry of the lanes at the origin
            assert torch.equal(a[:, :8], b[:, :8])


@pytest.mark.parametrize("horizon", [20, 60], ids=["n20", "n60"])
@pytest.mark.parametrize("reduced", [False, True], ids=["fp32", "head8"])
def test_k1_layouts_agree_bit_for_bit(dev, monkeypatch, horizon, reduced):
    """A lane's result does not depend on its layout: the quadrotor at N =
    20 (one pass) and N = 60 (sw 956), launched on its own plan (w2 in
    shared memory at N = 20, split over a cluster at N = 60, where its 10
    tiles leave the card idle) and forced onto w2 in global memory, gives
    the same bits (every product sums in index order, the reduced one in
    the tensor cores' order), carry included."""
    p, c = _quad(horizon, dev)
    args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(301, 12, 18, 0.3, dev), None)
    kw = dict(bf16_head_iters=8, check_termination=4) if reduced else {}
    full = _kw(12, 4, N=horizon, max_iter=120, relaxation_alpha=1.7, **kw)
    assert not K.fused_tile_plan(12, 4, horizon, reduced).w2_global
    own = K.condensed_fused_cuda(*args, **full)
    _forced(monkeypatch, K, "fused_tile_plan",
            K.global_tile_plan(12, 4, horizon, reduced))
    forced = K.condensed_fused_cuda(*args, **full)
    torch.cuda.synchronize()
    for a, b in zip(own[:4], forced[:4]):
        assert torch.equal(a, b)
    for a, b in zip(own[4], forced[4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("horizon", [20, 80], ids=["n20", "n80"])
@pytest.mark.parametrize("kw", [{}, dict(precision="default",
                                          check_termination=5)],
                         ids=["fp32", "default"])
def test_k2_global_iterates_agree_bit_for_bit(dev, monkeypatch, kw, horizon):
    """K2 at the quadrotor's N = 20 (tiles of 32 lanes, one pass each
    product) and N = 80 (sw 1,276: a tile of 32 split over a cluster) on
    its own plan and forced onto tiles of 32 lanes with the iterates in
    global memory, streamed in passes: the same bits, 150
    iterations, fp32 and with the reduced products of the iterations that
    neither check nor predict rho."""
    p, c = _quad(horizon, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(301, 12, 19, 0.3, dev), None)
    full = _k2_kw(p, c, **dict(_QUAD_KW, max_iter=150, **kw))
    lo = "precision" in kw
    assert not K2.adaptive_tile_plan(12, 4, horizon, 2, lo).iterates_global
    own = K2.condensed_adaptive_cuda(*args, **full)
    _forced(monkeypatch, K2, "adaptive_tile_plan",
            K2.global_adaptive_plan(12, 4, horizon, 2, lo))
    forced = K2.condensed_adaptive_cuda(*args, **full)
    torch.cuda.synchronize()
    for a, b in zip(own[:5], forced[:5]):
        assert torch.equal(a, b)
    for a, b in zip(own[5], forced[5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("blocks", [2, 8], ids=["cluster2", "cluster8"])
@pytest.mark.parametrize("horizon", [20, 60], ids=["n20", "n60"])
@pytest.mark.parametrize("reduced", [False, True], ids=["fp32", "head8"])
def test_k1_cluster_agrees_bit_for_bit(dev, monkeypatch, horizon, reduced,
                                       blocks):
    """The quadrotor at N = 20 and 60 forced onto w2 in shared memory (one
    pass; two passes of 512 rows) and onto a cluster of 2 or 8 blocks (each
    a slice of whole stages; at N = 60 a cluster of 2 runs two passes a
    block): the same bits, carry included, fp32 and with a reduced
    head."""
    p, c = _quad(horizon, dev)
    args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(301, 12, 18, 0.3, dev), None)
    kw = dict(bf16_head_iters=8, check_termination=4) if reduced else {}
    full = _kw(12, 4, N=horizon, max_iter=120, relaxation_alpha=1.7, **kw)
    shared = K.shared_tile_plan(12, 4, horizon, reduced)
    assert shared.cluster == 1
    _forced(monkeypatch, K, "fused_tile_plan", shared)
    own = K.condensed_fused_cuda(*args, **full)
    plan = K.cluster_tile_plan(12, 4, horizon, reduced, blocks=blocks)
    assert plan.cluster == blocks
    _forced(monkeypatch, K, "fused_tile_plan", plan)
    before = K.condensed_fused_cuda.launches
    forced = K.condensed_fused_cuda(*args, **full)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.launches == before + 1
    for a, b in zip(own[:4], forced[:4]):
        assert torch.equal(a, b)
    for a, b in zip(own[4], forced[4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("horizon", [80, 90], ids=["n80", "n90"])
@pytest.mark.parametrize("kw", [{}, dict(precision="default",
                                          check_termination=5)],
                         ids=["fp32", "default"])
def test_k2_cluster_agrees_bit_for_bit(dev, monkeypatch, kw, horizon):
    """K2 at the quadrotor's N = 80 and 90 forced onto tiles of 16 lanes in
    shared memory (both products in passes) and onto a cluster of 8 blocks
    sharing a tile of 32: the same bits, 150 iterations, carry included,
    fp32 and with the reduced products of the iterations that neither check
    nor predict rho."""
    p, c = _quad(horizon, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(301, 12, 19, 0.3, dev), None)
    full = _k2_kw(p, c, **dict(_QUAD_KW, max_iter=150, **kw))
    lo = "precision" in kw
    shared = K2.shared_adaptive_plan(12, 4, horizon, 2, lo)
    assert (shared.tile, shared.cluster) == (16, 1)
    _forced(monkeypatch, K2, "adaptive_tile_plan", shared)
    own = K2.condensed_adaptive_cuda(*args, **full)
    plan = K2.cluster_adaptive_plan(12, 4, horizon, 2, lo, blocks=8)
    _forced(monkeypatch, K2, "adaptive_tile_plan", plan)
    forced = K2.condensed_adaptive_cuda(*args, **full)
    torch.cuda.synchronize()
    for a, b in zip(own[:5], forced[:5]):
        assert torch.equal(a, b)
    for a, b in zip(own[5], forced[5]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("blocks", [3, 8], ids=["cluster3", "cluster8"])
@pytest.mark.parametrize("horizon", [80, 90], ids=["n80", "n90"])
def test_k2_cluster_osqp_controller_agrees_bit_for_bit(dev, monkeypatch,
                                                       horizon, blocks):
    """K2's OSQP-form controller on a cluster (its residuals read the next
    stage's rows from the cluster's copy of ux, their six maxima meet over
    the cluster): the quadrotor at N = 80 and 90 forced onto tiles of 16
    lanes in shared memory and onto a cluster of 3 (the smallest whose
    slices fit at N = 90, the plan's there) or 8 blocks, the same
    bits, 150 iterations, carry included; the cluster against the plain
    version on K1's bar, as the 16-lane tile's own test holds it (at 1,277
    and 1,437 columns cuBLAS need not sum in index order: at N = 90 a dual
    of the carry parts from the kernel's by 1.1e-4 of its size)."""
    p, c = _quad(horizon, dev)
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, _x0(301, 12, 19, 0.3, dev), None)
    full = _k2_kw(p, c, **dict(_QUAD_KW, controller="osqp",
                               adaptive_rho_min=3.0, max_iter=150))
    shared = K2.shared_adaptive_plan(12, 4, horizon, 2)
    assert (shared.tile, shared.cluster) == (16, 1)
    _forced(monkeypatch, K2, "adaptive_tile_plan", shared)
    own = K2.condensed_adaptive_cuda(*args, **full)
    plan = K2.cluster_adaptive_plan(12, 4, horizon, 2, blocks=blocks)
    assert plan.cluster == blocks
    _forced(monkeypatch, K2, "adaptive_tile_plan", plan)
    before = K2.condensed_adaptive_cuda.launches
    forced = K2.condensed_adaptive_cuda(*args, **full)
    r = K2.condensed_adaptive_reference(*args, **full)
    torch.cuda.synchronize()
    assert K2.condensed_adaptive_cuda.launches == before + 1
    for a, b in zip(own[:5], forced[:5]):
        assert torch.equal(a, b)
    for a, b in zip(own[5], forced[5]):
        assert torch.equal(a, b)
    assert bool((forced[4] != quadrotor.RHO).any())  # the controller moved
    same = (forced[2] == r[2]) & (forced[3] == r[3])
    assert same.float().mean().item() >= 0.99
    both = same & (forced[3] == 1) & (r[3] == 1)
    assert int(both.sum()) > 150
    for j in (0, 1):
        assert (forced[j] - r[j])[both].abs().max().item() <= 1e-4
    assert ((forced[4] - r[4]).abs() / r[4])[both].max().item() <= 1e-4


def _k1e_case(case, dev, grouped=False):
    """K1e's projected stages as the plain-version tests run them: the
    20-state chain at N = 8 (10 state cones of dim 2, 4 halfspace rows, an
    input cone over the 9 tensions, the state box; 500 lanes, 60
    iterations; ``grouped``: two groups of 250 lanes, the second's cone mu
    0.4 and halfspace rows 0.9 times the first's) or the rocket (its input
    and state cones and the state box; 1,000 lanes, 200 iterations).
    Returns (nx, nu, N, args, kw, agree)."""
    if case == "chain":
        Nc, nx, nu = 8, 20, 9
        p, c = _chain(Nc, dev, x_bound=3.0)
        rng = np.random.default_rng(11)
        a, b = rng.normal(size=(4, 20)), np.full(4, 5.0)
        G = 2 if grouped else 1
        if grouped:
            mu = np.array([0.5, 0.4])
            a, b = np.stack([a, 0.9 * a]), np.stack([b, b])
        else:
            mu = 0.5
        cons = K.fused_constraints(
            soc_x=tuple((2 * j, 2, mu) for j in range(10)), lin_x=(a, b),
            soc_u=((0, 9, 2.0),), nx=nx, nu=nu, dtype=torch.float32,
            device=dev, num_groups=G)
        x0 = _chain_x0(500, 12, dev)
        if grouped:
            x0 = x0.reshape(G, 250, nx)
        kw = _kw(nx, nu, N=Nc, max_iter=60, en_state_bound=True,
                 constraints=cons, **({"num_groups": G} if grouped else {}))
        agree = _counts_and_values_agree
    else:
        Nc, nx, nu = rocket.HORIZON, 6, 3
        s = _rocket(dev)
        p, c = s.problem, s.cache
        cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                                   nx=nx, nu=nu, dtype=torch.float32,
                                   device=dev)
        x0 = _rocket_x0(1000, dev)
        kw = _kw(nx, nu, N=Nc, abs_pri_tol=2e-3, relaxation_alpha=1.0,
                 max_iter=200, en_state_bound=True, constraints=cons)
        agree = _agree
    args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max, p.x_min,
            p.x_max, x0, None)
    return nx, nu, Nc, args, kw, agree


@pytest.mark.parametrize("blocks", [2, 8], ids=["cluster2", "cluster8"])
@pytest.mark.parametrize("stages", ["shared-buffers", "global-scratch"])
@pytest.mark.parametrize("case", ["chain", "rocket"])
def test_k1e_cluster_agrees_bit_for_bit(dev, monkeypatch, case, stages,
                                        blocks):
    """K1e on a cluster, each block projecting its own whole stages (its
    group's constraint data staged in its shared memory): the 20-state
    chain and the rocket forced onto w2 in shared memory and onto a cluster
    of 2 or 8 blocks, their stages projected in each thread's buffer in
    shared memory or in the global scratch: the same bits, carry included;
    the cluster against the plain version too."""
    nx, nu, Nc, args, kw, agree = _k1e_case(case, dev)
    if stages == "global-scratch":
        monkeypatch.setattr(K, "launch_smem",
                            lambda plan, *dims: (plan.smem, False))
    else:
        plan = K.cluster_tile_plan(nx, nu, Nc, blocks=blocks)
        assert K.launch_smem(plan, nx, nu)[1]
    shared = K.shared_tile_plan(nx, nu, Nc, state_free=False)
    _forced(monkeypatch, K, "fused_tile_plan", shared)
    own = K.condensed_fused_cuda(*args, **kw)
    plan = K.cluster_tile_plan(nx, nu, Nc, blocks=blocks)
    assert plan.cluster == blocks
    _forced(monkeypatch, K, "fused_tile_plan", plan)
    before = K.condensed_fused_cuda.projected_launches
    forced = K.condensed_fused_cuda(*args, **kw)
    r = K.condensed_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.projected_launches == before + 1
    for a, b in zip(own[:4], forced[:4]):
        assert torch.equal(a, b)
    for a, b in zip(own[4], forced[4]):
        assert torch.equal(a, b)
    agree(forced, r)


def test_k1e_cluster_at_the_rocket_budget_width(dev, monkeypatch):
    """The rocket at the JAX package's budget width (N = 643, sw 5,784):
    its plan splits a tile over a cluster of 8 blocks that project their
    own stages (cones and the state box); held bit for bit against w2 in
    global memory (forced), and against the plain version (>= 99% equal
    counts, x and u within 1e-4 of the larger of 1 and the entry)."""
    Nr = 643
    s = rocket.make_solver(Nr, dtype=torch.float32, device=dev)
    Xref, Uref = rocket.reference_trajectory(0, Nr, Nr)
    s.set_x_ref(Xref)
    s.set_u_ref(Uref)
    p, c = s.problem, s.cache
    cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                               nx=6, nu=3, dtype=torch.float32, device=dev)
    args = (build_condensed(p, c), float(c.rho), p.u_min, p.u_max, p.x_min,
            p.x_max, _rocket_x0(64, dev), None)
    kw = _kw(6, 3, N=Nr, abs_pri_tol=2e-3, relaxation_alpha=1.0,
             max_iter=30, en_state_bound=True, constraints=cons)
    plan = K.fused_tile_plan(6, 3, Nr, state_free=False)
    assert plan.cluster == 8 and K.launch_smem(plan, 6, 3)[1]
    before = K.condensed_fused_cuda.projected_launches
    own = K.condensed_fused_cuda(*args, **kw)
    r = K.condensed_fused_reference(*args, **kw)
    _forced(monkeypatch, K, "fused_tile_plan", K.global_tile_plan(6, 3, Nr))
    forced = K.condensed_fused_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.projected_launches == before + 2
    for a, b in zip(own[:4], forced[:4]):
        assert torch.equal(a, b)
    for a, b in zip(own[4], forced[4]):
        assert torch.equal(a, b)
    same = (own[2] == r[2]) & (own[3] == r[3])
    assert same.float().mean().item() >= 0.99
    for j in (0, 1):
        assert ((own[j] - r[j]).abs() / r[j].abs().clamp(min=1.0))[
            same].max().item() <= 1e-4


def _k2_projected_case(case, dev):
    """K2's projected stages as the plain-version tests run them: the
    rocket's cones and state box (termination controller, 1,000 lanes),
    the 20-state chain's stages of 20 and 9 under the OSQP-form controller
    (300 lanes, no projections), and the chain with 10 state cones, 4
    halfspace rows and the state box under the OSQP-form controller (300
    lanes).  Returns (nx, nu, args, kw)."""
    if case.startswith("rocket"):
        s = _rocket(dev)
        p, c = s.problem, s.cache
        nx, nu = 6, 3
        cons = K.fused_constraints(**K.problem_constraint_kw(p, s.settings),
                                   nx=nx, nu=nu, dtype=torch.float32,
                                   device=dev)
        x0 = _rocket_x0(1000, dev)
        kw = dict(controller="termination", en_state_bound=True,
                  abs_pri_tol=2e-3, adaptive_rho_min=1.0,
                  adaptive_rho_max=100.0, max_iter=100, constraints=cons)
    else:
        cones = case == "chain-osqp-cones"
        p, c = _chain(20, dev, x_bound=3.0 if cones else None)
        nx, nu = 20, 9
        x0 = _chain_x0(300, 13, dev)
        kw = dict(max_iter=150, adaptive_rho_min=0.2, adaptive_rho_max=5.0)
        if cones:
            rng = np.random.default_rng(11)
            kw.update(en_state_bound=True, max_iter=60,
                      constraints=K.fused_constraints(
                          soc_x=tuple((2 * j, 2, 0.5) for j in range(10)),
                          lin_x=(rng.normal(size=(4, 20)), np.full(4, 5.0)),
                          nx=nx, nu=nu, dtype=torch.float32, device=dev))
    args = (build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min,
            p.x_max, x0, None)
    return nx, nu, args, _k2_kw(p, c, **kw)


@pytest.mark.parametrize("blocks", [2, 8], ids=["cluster2", "cluster8"])
@pytest.mark.parametrize("case", ["rocket-cones", "chain-osqp",
                                  "chain-osqp-cones"])
def test_k2_cluster_projected_stages_agree_bit_for_bit(dev, monkeypatch,
                                                       case, blocks):
    """K2's stages on a cluster as the plain-version tests run them
    (``_k2_projected_case``: the rocket's cones, the chain's wide stages
    under the OSQP-form controller, without and with cones and
    halfspaces), forced onto the iterates in shared memory and onto a
    cluster of 2 or 8 blocks: the same bits, carry included; the cluster
    against the plain version too."""
    nx, nu, args, full = _k2_projected_case(case, dev)
    N_ = full["N"]
    state_free = case == "chain-osqp"
    shared = K2.shared_adaptive_plan(nx, nu, N_, 2, False, state_free)
    assert shared.cluster == 1
    _forced(monkeypatch, K2, "adaptive_tile_plan", shared)
    own = K2.condensed_adaptive_cuda(*args, **full)
    plan = K2.cluster_adaptive_plan(nx, nu, N_, 2, blocks=blocks)
    assert plan.cluster == blocks
    _forced(monkeypatch, K2, "adaptive_tile_plan", plan)
    before = K2.condensed_adaptive_cuda.launches
    forced = K2.condensed_adaptive_cuda(*args, **full)
    r = K2.condensed_adaptive_reference(*args, **full)
    torch.cuda.synchronize()
    assert K2.condensed_adaptive_cuda.launches == before + 1
    for a, b in zip(own[:5], forced[:5]):
        assert torch.equal(a, b)
    for a, b in zip(own[5], forced[5]):
        assert torch.equal(a, b)
    _k2_agree(forced, r)


@pytest.mark.parametrize("alpha", [1.0, 1.7], ids=["alpha1", "alpha1.7"])
@pytest.mark.parametrize("ct", [1, 4], ids=["ct1", "ct4"])
@pytest.mark.parametrize("case", ["rocket-cones", "chain-osqp-cones"])
def test_k2_projected_stages_match_plain_version(dev, case, ct, alpha):
    """K2 projects each stage once an iteration: in one pass that also
    takes its residuals, and under the OSQP-form controller once into the
    scratch that its residuals and the update pass then read.  The
    rocket's cones under the termination controller and the chain's 10
    cones and 4 halfspace rows under the OSQP-form one, at ct 1 and 4 and
    alpha 1 and 1.7, against the plain version: counts, values, rho and
    the carry."""
    nx, nu, args, full = _k2_projected_case(case, dev)
    full = dict(full, check_termination=ct, relaxation_alpha=alpha)
    own = K2.condensed_adaptive_cuda(*args, **full)
    r = K2.condensed_adaptive_reference(*args, **full)
    torch.cuda.synchronize()
    _k2_agree(own, r)


@pytest.mark.parametrize("box", [False, True], ids=["free", "state-box"])
@pytest.mark.parametrize("where", ["workspace", "workspace-and-stage",
                                   "generic-stage", "wide", "wide-matrices",
                                   "queue"])
def test_k3_far_layout_agrees_bit_for_bit(dev, monkeypatch, box, where):
    """K3 at N = 20 on its own plan (the near layout) and forced onto the far
    layout (the lanes' records in global memory, streamed through each lane
    group's ring): the same bits, and the plain version's counts and values
    on the lanes that solve.
    The quadrotor's fixed variant with the per-stage terms in shared and in
    global memory; the generic variant (a made-up 5 x 2 plant) with them in
    global memory; the wide variant on the 20-state chain with its matrices
    in shared and in global memory; and the quadrotor with a batch several
    times the grid's lane slots, so that slots take lanes from the queue
    and their records are reused."""
    batch, budget = 1001, 300
    if where.startswith("wide"):
        p, c = _chain(20, dev, x_bound=0.6 if box else None)
        x0 = _chain_x0(batch, 21, dev)
        if box:
            x0 = x0.clamp(-0.5, 0.5)
        budget = 200
    elif where.startswith("generic"):
        rng = np.random.default_rng(9)
        kw = {}
        if box:
            xb = np.tile(np.full(5, 0.3), (20, 1))
            kw = dict(x_min=-xb, x_max=xb)
        p = make_problem(np.eye(5) + rng.normal(size=(5, 5)) * 0.05,
                         rng.normal(size=(5, 2)) * 0.1, np.eye(5), np.eye(2),
                         1.0, 20, u_min=-1.0, u_max=1.0, dtype=torch.float32,
                         device=dev, **kw)
        c = precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
        x0 = _x0(batch, 5, 22, 0.25, dev)
    else:
        p, c = _quad(20, dev, x_bound=0.4 if box else None)
        if where == "queue":
            batch = 40000
        x0 = _x0(batch, 12, 20, 0.3, dev)
    full = dict(nx=p.nx, nu=p.nu, N=20, max_iter=budget, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=box, en_input_bound=True,
                check_termination=1)
    own = K3.fused_cuda(*_k3_args(p, c, x0), **full)
    assert not K3.launch_plan(p.nx, p.nu, 20, box, batch, dev)\
        .workspace_global
    if box and where.startswith(("workspace", "queue")):  # the bound binds
        assert float(own[0].abs().max()) == pytest.approx(0.4, abs=1e-7)
    elif not box:
        assert int((own[3] == 1).sum()) > batch // 2
    plan = K3.launch_plan(p.nx, p.nu, 20, box, batch, dev, far=True)
    assert plan.workspace_global and plan.ring >= K3.MIN_RING
    if where.endswith("stage"):
        plan = plan._replace(stage_global=True)
    if where == "wide-matrices":
        plan = plan._replace(matrices_global=True)
    if where == "queue":
        occ = K3.stage_occupancy(plan, p.nx, p.nu, box)["blocks_per_sm"]
        slots = occ * plan.tile * torch.cuda.get_device_properties(dev)\
            .multi_processor_count
        assert batch >= 3 * slots
    _forced(monkeypatch, K3, "fused_stage_plan", plan)
    before = K3.fused_cuda.launches
    forced = K3.fused_cuda(*_k3_args(p, c, x0), **full)
    torch.cuda.synchronize()
    assert K3.fused_cuda.launches == before + 1
    for a, b in zip(own, forced):
        assert torch.equal(a, b)
    # against the plain version: equal counts and flags on >= 99% of lanes,
    # 1e-4 on those that solved (its cuBLAS sums in another order move an
    # unsolved lane's last iterate further: 1.09e-4 at the boxed quadrotor)
    r = K3.fused_reference(*_k3_args(p, c, x0), **full)
    same = (forced[2] == r[2]) & (forced[3] == r[3])
    assert same.float().mean().item() >= 0.99
    both = same & (r[3] == 1)
    assert bool(both.any())
    for j in (0, 1):
        assert (forced[j] - r[j])[both].abs().max().item() <= 1e-4


# -- the warp layout: K1 on the narrow maps ----------------------------------

def _warp_vs_tiles(monkeypatch, f, free):
    """``f``'s launch on the warp layout (the plan's, checked) and on tiles
    of 32 lanes forced."""
    plan = K.warp_tile_plan(4, 1, N, free)
    assert plan is not None and K.fused_tile_plan(4, 1, N, False,
                                                  free) == plan
    before = K.condensed_fused_cuda.launches
    w = f()
    _forced(monkeypatch, K, "fused_tile_plan",
            K.shared_tile_plan(4, 1, N, False, free))
    t = f()
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert K.condensed_fused_cuda.launches == before + 2
    return w, t


@pytest.mark.parametrize("B,ct,alpha,bounded", [
    (8192, 1, 1.7, False), (1000, 1, 1.7, False), (1000, 4, 1.0, False),
    (1000, 1, 1.0, True), (1000, 4, 1.7, True)],
    ids=["8192-ct1-a1.7", "1000-ct1-a1.7", "1000-ct4-a1.0",
         "1000-ct1-a1.0-bounded", "1000-ct4-a1.7-bounded"])
def test_warp_layout_warm_launch_bit_for_bit(dev, monkeypatch, B, ct, alpha,
                                             bounded):
    """The fused MPC loop's warm launch (step 1 from step 0's carry, 100
    iterations, the carry out) on the warp layout: every lane's bits, carry
    included, equal the plain version's and those of tiles of 32 lanes
    forced, at the loop's 8,192 plants and at a ragged 1,000 (its last lane
    group holds 5 lanes), check_termination 1 and 4, alpha 1.0 and 1.7,
    state-free and with the constrained cartpole's state bound."""
    p, c, maps = _plant(cartpole, 5.0, dev,
                        np.array([2.0, 1e17, 1e17, 1e17]) if bounded
                        else None)
    args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max)
    kw = _kw(4, 1, max_iter=100, check_termination=ct,
             relaxation_alpha=alpha, en_state_bound=bounded)
    x0 = _x0(B, 4, 3, 0.5, dev)
    cold = K.condensed_fused_cuda(*args, x0, None, **kw)
    x1 = mpc._plant_step(p, x0, cold[1][:, 0, :]).contiguous()
    warm = dict(kw, warm_start=True)
    w, t = _warp_vs_tiles(
        monkeypatch, lambda: K.condensed_fused_cuda(*args, x1, cold[4],
                                                    **warm), not bounded)
    r = K.condensed_fused_reference(*args, x1, cold[4], **warm)
    assert int(w[3].sum()) > B // 2
    assert same_bits(w, t)
    assert same_bits(w, r)


def test_warp_layout_grouped_launch_with_pad_slots(dev, monkeypatch):
    """The mis-set cartpole's phase-2 launch of the bucketed rebuild (K1d
    over 5 buckets x 4,096 slots, warm, 450 iterations): its live lanes all
    lie in one bucket, every other slot is a pad (zero carry, zero x0); the
    warp layout's lanes equal the plain version's and those of tiles of 32
    forced, bit for bit."""
    from tinympc_julia_tpu_torch.ops.cuda.layout_probe import misset_launch
    f, valid = misset_launch(dev)
    live = valid.reshape(5, -1).sum(dim=1)
    assert int((live > 0).sum()) == 1 and int(live.sum()) > 1000
    w, t = _warp_vs_tiles(monkeypatch, f, False)
    r = K.condensed_fused_reference(*f.args, **f.keywords)
    assert same_bits(w, t)
    assert same_bits(w, r)
    assert (w[3][valid] == 1).float().mean().item() >= 0.9


def test_warp_layout_cold_launch_at_65536(dev, monkeypatch):
    """The headline's cold phase-0 launch (65,536 lanes, 56 iterations,
    one check at the end, the carry out) on the warp layout: bit for bit
    the plain version's and that of tiles of 32 forced."""
    p, c, maps = _plant(cartpole, 5.0, dev)
    args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
            _x0(65536, 4, 0, 0.5, dev), None)
    kw = _kw(4, 1, max_iter=56, check_termination=56)
    w, t = _warp_vs_tiles(
        monkeypatch, lambda: K.condensed_fused_cuda(*args, **kw), True)
    r = K.condensed_fused_reference(*args, **kw)
    assert same_bits(w, t)
    assert same_bits(w, r)


def test_warp_layout_takes_the_solvers_cached_layout(dev):
    """A solver keeps the plan and map layouts of the maps it was last
    given: a second launch on the same maps reuses them, an in-place change
    of the maps makes them anew, and the results stay those of a launch
    that makes its own."""
    p, c, maps = _plant(cartpole, 5.0, dev)
    args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max,
            _x0(777, 4, 7, 0.5, dev))
    kw = _kw(4, 1, max_iter=100)
    fn = K.make_condensed_fused_solver(
        **{k: v for k, v in kw.items() if k != "warm_start"})
    a, b = fn(*args), fn(*args)
    own = K.condensed_fused_cuda(*args, None, **kw)
    assert same_bits(a, own) and same_bits(b, own)
    maps.T12.mul_(1.0)  # bumps the version: the layouts are made anew
    assert same_bits(fn(*args), own)


@pytest.mark.parametrize("layout", ["warp", "tiles"])
def test_carry_of_a_lane_latching_at_cold_iteration_0(dev, monkeypatch,
                                                      layout):
    """A lane at the origin latches on a cold launch's first iteration
    (check_termination 1, carry out): its carry keeps the w2 and slacks it
    started from (zeros), as the plain version's does, on the warp layout
    and on tiles of 32 lanes forced, bit for bit; the other lanes take the
    plain version's bar (at 64 lanes its matmuls need not sum in index
    order)."""
    p, c, maps = _plant(cartpole, 5.0, dev)
    x0 = _x0(64, 4, 9, 0.5, dev)
    x0[:8] = 0.0
    args = (maps, float(c.rho), p.u_min, p.u_max, p.x_min, p.x_max, x0,
            None)
    kw = _kw(4, 1, max_iter=100)
    if layout == "tiles":
        _forced(monkeypatch, K, "fused_tile_plan",
                K.shared_tile_plan(4, 1, N))
    k = K.condensed_fused_cuda(*args, **kw)
    r = K.condensed_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert (k[2][:8] == 1).all() and (r[2][:8] == 1).all()
    for a, b in zip(k[4], r[4]):  # the carry of the lanes at the origin
        assert torch.equal(a[:, :8], b[:, :8])
    _agree(k, r)
