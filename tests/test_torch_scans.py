"""The port's long-horizon recursions (ops/scans.py) in float64 against the
JAX package's: the chunk maps, the chunked and associative forward and
backward passes (against JAX's and against the port's sequential passes),
the chunk-size rule, the full chunked solves through the API with equal
iteration counts, the ``auto`` dispatch, ``horizon_parallel`` in the solve,
the batched loop and the MPC loop, and the adaptive-rho refusal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole, quadrotor, rocket
from tinympc_julia_tpu.ops import admm as jadmm
from tinympc_julia_tpu.ops import scans as jscans
from tinympc_julia_tpu.ops.condensed import auto_chunk_size as jax_chunk_size
from tinympc_julia_tpu.parallel import batch as jbatch
from tinympc_julia_tpu.parallel.mpc import run_mpc_loop as jax_mpc_loop
from tinympc_julia_tpu_torch.ops import admm, scans
from tinympc_julia_tpu_torch.ops import condensed as PC
from tinympc_julia_tpu_torch.parallel import batch as PB
from tinympc_julia_tpu_torch.parallel.mpc import run_mpc_loop

from torch_port_common import CPU, port_copies

F64 = torch.float64
TOL = 1e-10


def _setup(model, N, seed=0, f=None):
    """JAX and port (problem, cache, state) of a plant at horizon N, the
    state's x0, d, p, q and r drawn from a seed (as tests/test_scans.py
    draws them)."""
    rng = np.random.default_rng(seed)
    jp = J.make_problem(jnp.asarray(model.A), jnp.asarray(model.B),
                        jnp.asarray(np.diag(model.Q_DIAG)),
                        jnp.asarray(np.diag(model.R_DIAG)), model.RHO, N,
                        f=None if f is None else jnp.asarray(f))
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R,
                            jnp.asarray(model.RHO, jp.A.dtype))
    nx, nu = model.NX, model.NU
    draws = dict(x0=rng.normal(size=nx), d=rng.normal(size=(N - 1, nu)),
                 p=rng.normal(size=(N, nx)), q=rng.normal(size=(N, nx)),
                 r=rng.normal(size=(N - 1, nu)))
    jst = J.init_state(nx, nu, N, jp.A.dtype)
    jst = jst.replace(x=jst.x.at[0].set(jnp.asarray(draws["x0"])),
                      **{k: jnp.asarray(draws[k]) for k in "dpqr"})
    pp, pc = port_copies(jp, jc, jnp.float64)
    pst = P.init_state(nx, nu, N, dtype=F64, device=CPU)
    x = pst.x.clone()
    x[0] = torch.as_tensor(draws["x0"])
    pst = pst.replace(x=x, **{k: torch.as_tensor(draws[k]) for k in "dpqr"})
    return (jp, jc, jst), (pp, pc, pst)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, err_msg=what)


CHUNK_CASES = [(cartpole, 21, 4, None), (quadrotor, 21, 5, None),
               (rocket, 11, 5, rocket.F)]
CHUNK_IDS = ["cartpole", "quadrotor", "rocket-affine"]


@pytest.mark.parametrize("model,N,C,f", CHUNK_CASES, ids=CHUNK_IDS)
def test_chunk_maps_match_jax(model, N, C, f):
    (jp, jc, _), (pp, pc, _) = _setup(model, N, f=f)
    jm = jscans.build_chunk_maps(jp, jc, C)
    pm = scans.build_chunk_maps(pp, pc, C)
    for name in scans.ChunkMaps._fields:
        np.testing.assert_allclose(getattr(pm, name).numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    assert scans.chunk_size_from_maps(pm, model.NX, model.NU) == C
    with pytest.raises(ValueError, match="must divide"):
        scans.build_chunk_maps(pp, pc, C + 3)


@pytest.mark.parametrize("model,N,C,f", CHUNK_CASES, ids=CHUNK_IDS)
def test_chunked_passes_match_jax_and_sequential(model, N, C, f):
    (jp, jc, jst), (pp, pc, pst) = _setup(model, N, f=f)
    jm = jscans.build_chunk_maps(jp, jc, C)
    pm = scans.build_chunk_maps(pp, pc, C)
    fw = scans.forward_pass_chunked(pst, pp, pc, pm)
    jfw = jscans.forward_pass_chunked(jst, jp, jc, jm)
    seq = admm.forward_pass(pst, pp, pc)
    bw = scans.backward_pass_chunked(pst, pp, pc, pm)
    jbw = jscans.backward_pass_chunked(jst, jp, jc, jm)
    bseq = admm.backward_pass(pst, pp, pc)
    for a, ja, s, what in ((fw.x, jfw.x, seq.x, "x"), (fw.u, jfw.u, seq.u,
                                                       "u"),
                           (bw.p, jbw.p, bseq.p, "p"),
                           (bw.d, jbw.d, bseq.d, "d")):
        _close(a, ja, f"{what} vs JAX")
        _close(a, s, f"{what} vs sequential")


@pytest.mark.parametrize("model,N", [(cartpole, 20), (quadrotor, 20),
                                     (cartpole, 37)],
                         ids=["cartpole", "quadrotor", "cartpole-N37"])
def test_assoc_passes_match_jax_and_sequential(model, N):
    """N = 37: 36 stages, not a power of two (a ragged last doubling)."""
    (jp, jc, jst), (pp, pc, pst) = _setup(model, N)
    fw = scans.forward_pass_assoc(pst, pp, pc)
    jfw = jscans.forward_pass_assoc(jst, jp, jc)
    seq = admm.forward_pass(pst, pp, pc)
    bw = scans.backward_pass_assoc(pst, pp, pc)
    jbw = jscans.backward_pass_assoc(jst, jp, jc)
    bseq = admm.backward_pass(pst, pp, pc)
    assert torch.equal(admm.backward_pass(pst, pp, pc,
                                          horizon_parallel=True).p, bw.p)
    for a, ja, s, what in ((fw.x, jfw.x, seq.x, "x"), (fw.u, jfw.u, seq.u,
                                                       "u"),
                           (bw.p, jbw.p, bseq.p, "p"),
                           (bw.d, jbw.d, bseq.d, "d")):
        _close(a, ja, f"{what} vs JAX")
        _close(a, s, f"{what} vs sequential")


def test_assoc_long_horizon_stays_finite():
    """N = 512: the closed-loop matrix is stable, so its powers contract and
    the scan stays within 1e-8 of the sequential rollout."""
    (_, _, _), (pp, pc, pst) = _setup(cartpole, 512)
    fw = scans.forward_pass_assoc(pst, pp, pc)
    seq = admm.forward_pass(pst, pp, pc)
    assert torch.isfinite(fw.x).all()
    np.testing.assert_allclose(fw.x.numpy(), seq.x.numpy(), rtol=1e-8,
                               atol=1e-8)


def test_passes_take_a_batch_axis():
    """A leading batch axis on the state, and on the problem and cache too:
    each instance's result equals its own unbatched pass."""
    outs = [_setup(cartpole, 21, seed=s)[1] for s in range(3)]
    pp, pc = outs[0][0], outs[0][1]
    st = P.stack_instances([o[2] for o in outs])
    pps = P.stack_instances([pp] * 3)
    pcs = P.stack_instances([pc] * 3)
    cm = scans.build_chunk_maps(pp, pc, 4)
    for fn in (lambda s, p, c: scans.forward_pass_chunked(s, p, c, cm),
               lambda s, p, c: scans.backward_pass_chunked(s, p, c, cm),
               scans.forward_pass_assoc, scans.backward_pass_assoc):
        shared = fn(st, pp, pc)
        per_instance = fn(st, pps, pcs)
        for b, (_, _, sb) in enumerate(outs):
            one = fn(sb, pp, pc)
            for name in ("x", "u", "p", "d"):
                _close(getattr(shared, name)[b], getattr(one, name), name)
                _close(getattr(per_instance, name)[b], getattr(one, name),
                       name)


@pytest.mark.parametrize("nx,nu,N", [(4, 1, 2049), (4, 1, 2048),
                                     (12, 4, 501), (4, 1, 1537),
                                     (12, 4, 2000), (4, 1, 3)])
def test_auto_chunk_size_matches_jax(nx, nu, N):
    assert PC.auto_chunk_size(nx, nu, N) == jax_chunk_size(nx, nu, N)
    C = PC.auto_chunk_size(nx, nu, N)
    assert C is None or (N - 1) % C == 0


def _cartpole_solvers(N, max_iter, **settings):
    """The same cartpole solver in both packages, float64, |u| <= 5."""
    pair = (J.TinyMPCSolver(), P.TinyMPCSolver(dtype=F64, device=CPU))
    for s in pair:
        s.setup(np.asarray(cartpole.A), np.asarray(cartpole.B), None,
                np.diag(cartpole.Q_DIAG), np.diag(cartpole.R_DIAG), 1.0, 4,
                1, N, max_iter=max_iter, **settings)
        s.set_bound_constraints(np.full((4, N), -1e17), np.full((4, N), 1e17),
                                np.full((1, N - 1), -5.0),
                                np.full((1, N - 1), 5.0))
    return pair


def test_solve_chunked_matches_jax():
    """solve(chunked=True) at N = 65 (chunk 16, through the chunk maps the
    solver builds and keeps): the JAX package's iteration count, and its
    controls within 1e-9, on a closed loop of three solves."""
    js, ps = _cartpole_solvers(65, 200)
    x = np.array([0.5, 0.0, 0.1, 0.0])
    for _ in range(3):
        for s in (js, ps):
            s.set_x0(x)
            s.solve(chunked=True)
        assert int(ps.solution.iter) == int(js.solution.iter)
        np.testing.assert_allclose(ps.get_solution().controls,
                                   js.get_solution().controls, atol=1e-9)
        x = cartpole.A @ x + cartpole.B @ js.get_solution().controls[:, 0]
    assert ps._chunk_maps is not None
    assert scans.chunk_size_from_maps(ps._chunk_maps, 4, 1) == \
        PC.auto_chunk_size(4, 1, 65)


def test_solve_batch_chunked_matches_jax():
    js, ps = _cartpole_solvers(65, 100)
    x0s = np.random.default_rng(7).uniform(-0.5, 0.5, size=(8, 4))
    j = js.solve_batch(x0s, method="chunked")
    p = ps.solve_batch(x0s, method="chunked")
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_array_equal(p[3].numpy(), np.asarray(j[3]))
    np.testing.assert_allclose(p[1].numpy(), np.asarray(j[1]), atol=1e-9)
    # and the sequential loop: the same counts, values to reassociation
    s = ps.solve_batch(x0s, method="standard")
    assert torch.equal(s[2], p[2])
    np.testing.assert_allclose(p[1].numpy(), s[1].numpy(), atol=1e-9)
    assert int(p[3].sum()) > 0


def test_auto_dispatches_long_horizons_to_the_chunked_path():
    """N = 1537 (N-1 = 2^9 x 3): the condensed maps exceed the budget, a
    chunk size fits, so ``auto`` and ``solve()`` take the chunked path as
    the JAX package does, with its iteration counts."""
    N = 1537
    assert not PC.auto_uses_condensed(4, 1, N)
    assert PC.auto_chunk_size(4, 1, N) is not None
    js, ps = _cartpole_solvers(N, 25)
    x0s = np.random.default_rng(8).uniform(-0.2, 0.2, size=(4, 4))
    j = js.solve_batch(x0s, method="auto")
    p = ps.solve_batch(x0s, method="auto")
    assert ps._chunk_maps is not None and ps._condensed_maps is None
    np.testing.assert_array_equal(p[2].numpy(), np.asarray(j[2]))
    np.testing.assert_allclose(p[1].numpy(), np.asarray(j[1]), atol=1e-9)
    c = ps.solve_batch(x0s, method="chunked")
    assert torch.equal(c[2], p[2]) and torch.equal(c[1], p[1])
    for s in (js, ps):
        s.set_x0([0.3, 0.0, 0.05, 0.0])
        s.solve()
    assert int(ps.solution.iter) == int(js.solution.iter)
    np.testing.assert_allclose(ps.get_solution().controls,
                               js.get_solution().controls, atol=1e-9)


def test_auto_respects_the_budget(monkeypatch):
    """At N = 100 ``auto`` builds the condensed maps; with a budget of one
    byte it takes the chunked path instead, with the same counts (the
    counterpart of test_condensed.py::TestAutoDispatch)."""
    x0s = np.random.default_rng(0).uniform(-0.3, 0.3, size=(4, 4))
    _, s1 = _cartpole_solvers(100, 20)
    a = s1.solve_batch(x0s, method="auto")
    assert s1._condensed_maps is not None and s1._chunk_maps is None
    monkeypatch.setattr(PC, "AUTO_CONDENSED_BUDGET_BYTES", 1)
    _, s2 = _cartpole_solvers(100, 20)
    b = s2.solve_batch(x0s, method="auto")
    assert s2._condensed_maps is None and s2._chunk_maps is not None
    assert torch.equal(a[2], b[2])
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=1e-9)


def test_setters_drop_the_chunk_maps():
    _, ps = _cartpole_solvers(65, 50)
    ps.set_x0([0.2, 0.0, 0.0, 0.0])
    ps.solve(chunked=True)
    assert ps._chunk_maps is not None
    ps.set_x_ref(np.full((4, 65), 0.1))
    assert ps._chunk_maps is None


def test_horizon_parallel_solve_matches_jax():
    """``horizon_parallel = True``: the single solve on the associative
    scans, against the JAX package's and the sequential one."""
    js, ps = _cartpole_solvers(20, 100)
    _, seq = _cartpole_solvers(20, 100)
    js.horizon_parallel = ps.horizon_parallel = True
    for s in (js, ps, seq):
        s.set_x0([0.5, 0.0, 0.0, 0.0])
        s.solve()
    assert int(ps.solution.iter) == int(js.solution.iter) == \
        int(seq.solution.iter)
    assert ps._chunk_maps is None  # auto never chunks a horizon_parallel solve
    for other in (js, seq):
        np.testing.assert_allclose(ps.get_solution().controls,
                                   other.get_solution().controls, atol=1e-9)


def test_batch_horizon_parallel_matches_jax():
    (jp, jc, _), (pp, pc, _) = _setup(cartpole, 20)
    jp = jp.replace(u_min=jnp.full_like(jp.u_min, -5.0),
                    u_max=jnp.full_like(jp.u_max, 5.0))
    pp = pp.replace(u_min=torch.full_like(pp.u_min, -5.0),
                    u_max=torch.full_like(pp.u_max, 5.0))
    x0s = np.random.default_rng(3).uniform(-0.5, 0.5, size=(6, 4))
    kw = dict(max_iter=100, en_state_bound=False)
    jst = jbatch.set_x0_batch(jbatch.broadcast_state(
        J.init_state(4, 1, 20, jp.A.dtype), 6), jnp.asarray(x0s))
    pst = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(4, 1, 20, dtype=F64, device=CPU), 6),
        torch.as_tensor(x0s))
    _, _, jsol = jbatch.solve_batch(jp, jc, J.Settings(**kw), jst,
                                    horizon_parallel=True)
    _, _, psol = PB.solve_batch(pp, pc, P.Settings(**kw), pst,
                                horizon_parallel=True)
    np.testing.assert_array_equal(psol.iter.numpy(), np.asarray(jsol.iter))
    np.testing.assert_allclose(psol.u.numpy(), np.asarray(jsol.u), atol=1e-9)


def test_run_mpc_loop_horizon_parallel_matches_jax():
    """run_mpc_loop(horizon_parallel=True), two cartpole plants x 10
    steps, fixed and adaptive rho, against the JAX loop."""
    (jp, jc, _), (pp, pc, _) = _setup(cartpole, 20)
    jp = jp.replace(u_min=jnp.full_like(jp.u_min, -5.0),
                    u_max=jnp.full_like(jp.u_max, 5.0))
    pp = pp.replace(u_min=torch.full_like(pp.u_min, -5.0),
                    u_max=torch.full_like(pp.u_max, 5.0))
    x0s = np.array([[0.0, 0.0, 0.1, 0.0], [0.5, 0.0, -0.05, 0.0]])
    for kw in (dict(max_iter=100, en_state_bound=False),
               dict(max_iter=100, en_state_bound=False, adaptive_rho=True,
                    adaptive_rho_min=0.5, adaptive_rho_max=5.0)):
        j = jax_mpc_loop(jp, jc, J.Settings(**kw), jnp.asarray(x0s), 10,
                         horizon_parallel=True)
        p = run_mpc_loop(pp, pc, P.Settings(**kw), torch.as_tensor(x0s), 10,
                         horizon_parallel=True)
        np.testing.assert_array_equal(p.iters.numpy(), np.asarray(j.iters))
        np.testing.assert_allclose(p.us.numpy(), np.asarray(j.us), atol=1e-9)
        seq = run_mpc_loop(pp, pc, P.Settings(**kw), torch.as_tensor(x0s),
                           10)
        assert torch.equal(seq.iters, p.iters)


def test_chunked_paths_refuse_adaptive_rho():
    """The chunk maps bake the setup-time gains: adaptive rho is refused by
    the solve, the batched loop and the API, as in the JAX package."""
    (jp, jc, jst), (pp, pc, pst) = _setup(cartpole, 21)
    cm = scans.build_chunk_maps(pp, pc, 4)
    s = P.Settings(adaptive_rho=True)
    with pytest.raises(ValueError, match="adaptive_rho"):
        jadmm.make_loop_fns(jp, J.Settings(adaptive_rho=True),
                            chunk_maps=jscans.build_chunk_maps(jp, jc, 4))
    with pytest.raises(ValueError, match="adaptive_rho"):
        admm.solve(pp, pc, s, pst, chunk_maps=cm)
    with pytest.raises(ValueError, match="adaptive_rho"):
        PB.solve_batch(pp, pc, s, PB.broadcast_state(pst, 2), chunk_maps=cm)
    js, ps = _cartpole_solvers(65, 50, adaptive_rho=True)
    for solver in (js, ps):
        with pytest.raises(ValueError, match="adaptive_rho"):
            solver.solve(chunked=True)
    # auto never picks the chunked path under adaptive rho
    _, long = _cartpole_solvers(1537, 5, adaptive_rho=True)
    long.set_x0([0.1, 0.0, 0.0, 0.0])
    long.solve()
    assert long._chunk_maps is None
