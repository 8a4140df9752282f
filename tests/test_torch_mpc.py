"""The port's closed-loop MPC loops (parallel/mpc.py) and
``condensed.ref_backward_const`` against the JAX package: the
reference-ordered and the condensed loop in float64 (controls within 1e-10,
1e-9 with moving references, per-step iteration counts equal), the fused
loop on kernel K1's plain version against the JAX loop on its Pallas kernel
in interpret mode in float32 (1e-5: fp32 sums in another order), and the
reference-ordered loop against the compiled reference's record in
tests/golden/cartpole_mpc.npz."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole, rocket
from tinympc_julia_tpu.ops import condensed as jcond
from tinympc_julia_tpu.parallel import mpc as jmpc
from tinympc_julia_tpu_torch.ops import condensed as pcond
from tinympc_julia_tpu_torch.ops.cuda.condensed_kernel import (
    condensed_fused_reference)
from tinympc_julia_tpu_torch.parallel import mpc as pmpc
from tinympc_julia_tpu_torch.parallel import run_mpc_loop
from tinympc_julia_tpu_torch.utils import convert

from torch_port_common import (CART_X_BOUND, INTERPRET, jax_arrays,
                               port_copies, settings_pair)

F64, F32 = jnp.float64, jnp.float32
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _cartpole(dtype=F64, ub=5.0, x_bound=None, refs=None):
    kw = {}
    if x_bound is not None:
        xb = np.tile(x_bound, (20, 1))
        kw = dict(x_min=jnp.asarray(-xb, dtype), x_max=jnp.asarray(xb, dtype))
    if refs is not None:
        kw.update(Xref=jnp.asarray(refs[0], dtype),
                  Uref=jnp.asarray(refs[1], dtype))
    jp = J.make_problem(jnp.asarray(cartpole.A, dtype),
                        jnp.asarray(cartpole.B, dtype),
                        jnp.asarray(np.diag(cartpole.Q_DIAG), dtype),
                        jnp.asarray(np.diag(cartpole.R_DIAG), dtype), 1.0, 20,
                        u_min=-ub, u_max=ub, **kw)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(1.0, dtype))
    return (jp, jc), port_copies(jp, jc, dtype)


def _rocket(N=10):
    """The rocket of tests/test_mpc_loop.py: box on the thrust, the affine
    gravity term, a reference that moves every step."""
    jp = J.make_problem(jnp.asarray(rocket.A), jnp.asarray(rocket.B),
                        jnp.asarray(np.diag(rocket.Q_DIAG)),
                        jnp.asarray(np.diag(rocket.R_DIAG)), 1.0, N,
                        f=jnp.asarray(rocket.F), u_min=-10.0, u_max=105.0)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R,
                            jnp.asarray(1.0, jp.A.dtype))
    return (jp, jc), port_copies(jp, jc, F64)


def _rocket_schedule(n_steps):
    Xrefs = np.stack([rocket.reference_trajectory(k)[0].T
                      for k in range(n_steps)])
    Urefs = np.stack([rocket.reference_trajectory(k)[1].T
                      for k in range(n_steps)])
    return Xrefs, Urefs


CART_X0 = np.array([[0.0, 0.0, 0.1, 0.0], [0.5, 0.0, -0.05, 0.0]])
ROCKET_S = dict(max_iter=100, abs_pri_tol=2e-3, en_state_bound=False)


def _same_loop(pres, jres, atol):
    np.testing.assert_array_equal(pres.iters.numpy(), np.asarray(jres.iters))
    np.testing.assert_array_equal(pres.solved.numpy(),
                                  np.asarray(jres.solved))
    np.testing.assert_allclose(pres.us.numpy(), np.asarray(jres.us),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(pres.xs.numpy(), np.asarray(jres.xs),
                               atol=atol, rtol=0)


# -- ref_backward_const ------------------------------------------------------

def _random_refs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(20, 4)) * 0.1, rng.normal(size=(19, 1)) * 0.05


def test_ref_backward_const_matches_jax():
    (jp, jc), (pp, pc) = _cartpole(refs=_random_refs())
    ours = pcond.ref_backward_const(pp, pc)
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(jcond.ref_backward_const(jp, jc)),
        atol=1e-12, rtol=0)
    assert ours.shape == (19,)
    # explicit references override the problem's
    Xr, Ur = _random_refs(1)
    np.testing.assert_allclose(
        pcond.ref_backward_const(pp, pc, torch.as_tensor(Xr),
                                 torch.as_tensor(Ur)).numpy(),
        np.asarray(jcond.ref_backward_const(jp, jc, jnp.asarray(Xr),
                                            jnp.asarray(Ur))),
        atol=1e-12, rtol=0)


def test_ref_backward_const_is_the_baked_maps_constant():
    """Maps baked with references equal reference-free maps plus d_ref."""
    _, (pp_ref, pc) = _cartpole(refs=_random_refs())
    _, (pp, _) = _cartpole()
    baked = pcond.build_condensed(pp_ref, pc)
    free = pcond.build_condensed(pp, pc)
    torch.testing.assert_close(baked.T2[:, -1] - free.T2[:, -1],
                               pcond.ref_backward_const(pp_ref, pc),
                               atol=1e-12, rtol=0)
    torch.testing.assert_close(baked.T2[:, :-1], free.T2[:, :-1], atol=0,
                               rtol=0)


def test_d_ref_solves_for_moving_references():
    """The condensed solve on reference-free maps with d_ref equals the one
    on maps with the references baked in."""
    _, (pp_ref, pc) = _cartpole(refs=_random_refs())
    _, (pp, _) = _cartpole()
    s = P.Settings(max_iter=80, en_state_bound=False)
    x0 = torch.as_tensor(CART_X0)
    a = pcond.solve_condensed(pp_ref, pc, s, x0)
    b = pcond._solve_condensed_impl(
        pp, pc, s, x0, pcond.build_condensed(pp, pc), None,
        d_ref=pcond.ref_backward_const(pp_ref, pc))
    assert torch.equal(a[2], b[2]) and int(a[3].sum()) == 2
    torch.testing.assert_close(a[1], b[1], atol=1e-10, rtol=0)


# -- run_mpc_loop ------------------------------------------------------------

def test_run_mpc_loop_matches_jax_cartpole():
    (jp, jc), (pp, pc) = _cartpole()
    js, ps = settings_pair(max_iter=100, en_state_bound=False)
    jres = jmpc.run_mpc_loop(jp, jc, js, jnp.asarray(CART_X0), 25)
    pres = run_mpc_loop(pp, pc, ps, torch.as_tensor(CART_X0), 25)
    assert pres.us.shape == (2, 25, 1) and pres.xs.shape == (2, 25, 4)
    assert pres.iters.dtype == torch.int32
    _same_loop(pres, jres, 1e-10)
    # the final workspace and cache, field by field
    for k, v in jax_arrays(jres.state).items():
        np.testing.assert_allclose(convert.to_numpy(pres.state)[k], v,
                                   atol=1e-9, rtol=0, err_msg=f"state.{k}")
    assert pres.cache.rho.ndim == 0  # fixed rho: the cache stays shared
    assert int(pres.iters[:, 1:].max()) < int(pres.iters[:, 0].min())


def test_run_mpc_loop_reference_schedule_matches_jax():
    (jp, jc), (pp, pc) = _rocket()
    js, ps = settings_pair(**ROCKET_S)
    Xrefs, Urefs = _rocket_schedule(20)
    x0 = np.stack([rocket.X_INIT, rocket.X_INIT * 1.05])
    jres = jmpc.run_mpc_loop(jp, jc, js, jnp.asarray(x0), 20, Xrefs=Xrefs,
                             Urefs=Urefs)
    pres = run_mpc_loop(pp, pc, ps, torch.as_tensor(x0), 20, Xrefs=Xrefs,
                        Urefs=Urefs)
    _same_loop(pres, jres, 1e-9)
    us = pres.us.numpy()
    assert (us >= -10.0 - 1e-6).all() and (us <= 105.0 + 1e-6).all()
    assert (pres.xs.numpy()[:, :, 2] > 0).all()
    # a schedule without Urefs takes zeros
    j0 = jmpc.run_mpc_loop(jp, jc, js, jnp.asarray(x0), 3, Xrefs=Xrefs[:3])
    p0 = run_mpc_loop(pp, pc, ps, torch.as_tensor(x0), 3, Xrefs=Xrefs[:3])
    _same_loop(p0, j0, 1e-9)


def test_run_mpc_loop_adaptive_rho_matches_jax():
    """The adaptive case of tests/test_mpc_loop.py: the shared cache becomes
    per-instance and is carried from step to step; equal final rhos."""
    (jp, jc), (pp, pc) = _cartpole(ub=1.0)
    js, ps = settings_pair(max_iter=100, en_state_bound=False,
                           adaptive_rho=True, adaptive_rho_min=0.5,
                           adaptive_rho_max=5.0)
    x0 = np.array([[1.0, 0.0, 0.2, 0.0], [-0.5, 0.3, 0.0, 0.0]])
    jres = jmpc.run_mpc_loop(jp, jc, js, jnp.asarray(x0), 10)
    pres = run_mpc_loop(pp, pc, ps, torch.as_tensor(x0), 10)
    _same_loop(pres, jres, 1e-9)
    rhos = pres.cache.rho.numpy()
    assert rhos.shape == (2,) and ((rhos >= 0.5) & (rhos <= 5.0)).all()
    assert (rhos != 1.0).any()
    for k in ("rho", "Kinf", "Pinf", "C1", "C2"):
        np.testing.assert_allclose(convert.to_numpy(pres.cache)[k],
                                   np.asarray(getattr(jres.cache, k)),
                                   atol=1e-9, rtol=0, err_msg=k)


def test_run_mpc_loop_tracks_the_compiled_reference():
    """tests/golden/cartpole_mpc.npz: 60 warm-started steps of the
    constrained cartpole; per-step states, controls (1e-6) and iteration
    counts, and the last solve's slacks."""
    g = np.load(os.path.join(GOLDEN, "cartpole_mpc.npz"))
    _, (pp, pc) = _cartpole(x_bound=CART_X_BOUND)
    n = g["mpc_us"].shape[1]
    res = run_mpc_loop(pp, pc, P.Settings(max_iter=100),
                       torch.tensor([[0.0, 0.0, 0.1, 0.0]],
                                    dtype=torch.float64), n)
    np.testing.assert_array_equal(res.iters[0].numpy(),
                                  g["mpc_iters"][0].astype(np.int32))
    np.testing.assert_allclose(res.us[0].numpy(), g["mpc_us"].T, atol=1e-6)
    np.testing.assert_allclose(res.xs[0].numpy(), g["mpc_xs"].T, atol=1e-6)
    np.testing.assert_allclose(res.state.vnew[0].numpy(),
                               g["mpc_final_vnew"].T, atol=1e-6)
    np.testing.assert_allclose(res.state.znew[0].numpy(),
                               g["mpc_final_znew"].T, atol=1e-6)


# -- run_mpc_loop_condensed --------------------------------------------------

CART_X0_C = np.array([[0.0, 0.0, 0.1, 0.0], [0.4, -0.1, -0.05, 0.0]])


@pytest.mark.parametrize("alpha", [1.0, 1.7])
def test_condensed_loop_matches_jax_and_the_standard_loop(alpha):
    (jp, jc), (pp, pc) = _cartpole()
    js, ps = settings_pair(max_iter=100, en_state_bound=False,
                           relaxation_alpha=alpha)
    x0 = torch.as_tensor(CART_X0_C)
    jres = jmpc.run_mpc_loop_condensed(jp, jc, js, jnp.asarray(CART_X0_C),
                                       20)
    pres = pmpc.run_mpc_loop_condensed(pp, pc, ps, x0, 20)
    _same_loop(pres, jres, 1e-10)
    std = run_mpc_loop(pp, pc, ps, x0, 20)
    assert torch.equal(pres.iters, std.iters)
    torch.testing.assert_close(pres.us, std.us, atol=1e-10, rtol=0)
    torch.testing.assert_close(pres.xs, std.xs, atol=1e-10, rtol=0)


def test_condensed_loop_with_moving_references():
    (jp, jc), (pp, pc) = _rocket()
    js, ps = settings_pair(**ROCKET_S)
    Xrefs, Urefs = _rocket_schedule(15)
    x0 = rocket.X_INIT[None, :]
    jres = jmpc.run_mpc_loop_condensed(jp, jc, js, jnp.asarray(x0), 15,
                                       Xrefs=Xrefs, Urefs=Urefs)
    pres = pmpc.run_mpc_loop_condensed(pp, pc, ps, torch.as_tensor(x0), 15,
                                       Xrefs=Xrefs, Urefs=Urefs)
    _same_loop(pres, jres, 1e-9)
    std = run_mpc_loop(pp, pc, ps, torch.as_tensor(x0), 15, Xrefs=Xrefs,
                       Urefs=Urefs)
    assert torch.equal(pres.iters, std.iters)
    torch.testing.assert_close(pres.us, std.us, atol=1e-9, rtol=0)


def test_condensed_loop_uses_the_problems_fixed_references():
    """Without a schedule the problem's own references enter through d_ref
    (the maps are built for zero references)."""
    _, (pp, pc) = _cartpole(refs=_random_refs())
    ps = P.Settings(max_iter=100, en_state_bound=False)
    x0 = torch.as_tensor(CART_X0_C)
    cond = pmpc.run_mpc_loop_condensed(pp, pc, ps, x0, 8)
    std = run_mpc_loop(pp, pc, ps, x0, 8)
    assert torch.equal(cond.iters, std.iters)
    torch.testing.assert_close(cond.us, std.us, atol=1e-10, rtol=0)
    with pytest.raises(ValueError, match="fixed-rho"):
        pmpc.run_mpc_loop_condensed(pp, pc, ps.replace(adaptive_rho=True),
                                    x0, 2)


# -- the fused loop ----------------------------------------------------------

def _fused_x0():
    return np.random.default_rng(5).uniform(-0.4, 0.4, size=(16, 4))


@pytest.mark.parametrize("alpha", [1.0, 1.7])
def test_fused_loop_matches_jax(alpha):
    """16 lanes x 20 steps on K1's plain version against the JAX loop on the
    Pallas kernel (interpret mode).  alpha = 1.7 makes the carry's z
    visible: it must be the pre-convergence iterate, not the latched
    solution."""
    (jp, jc), (pp, pc) = _cartpole(F32)
    js, ps = settings_pair(max_iter=200, en_state_bound=False,
                           relaxation_alpha=alpha)
    x0 = _fused_x0()
    jres = jmpc.run_mpc_loop_fused(jp, jc, js, jnp.asarray(x0, F32), 20,
                                   batch_tile=16, interpret=INTERPRET)
    loop = pmpc.make_fused_mpc_loop(pp, pc, ps, 20)
    pres = loop(x0)  # numpy in float64: cast to the problem's dtype
    assert pres.us.dtype == torch.float32 and pres.us.shape == (16, 20, 1)
    assert bool(pres.solved.all())
    _same_loop(pres, jres, 1e-5)
    # the same loop function again: nothing carries over between calls
    again = loop(torch.as_tensor(x0, dtype=torch.float32))
    assert torch.equal(again.us, pres.us)


@pytest.mark.parametrize("alpha", [1.0, 1.7])
def test_fused_loop_matches_the_ports_condensed_loop(alpha):
    _, (pp, pc) = _cartpole(F32)
    ps = P.Settings(max_iter=200, en_state_bound=False,
                    relaxation_alpha=alpha)
    x0 = torch.as_tensor(_fused_x0(), dtype=torch.float32)
    fused = pmpc.run_mpc_loop_fused(pp, pc, ps, x0, 20)
    cond = pmpc.run_mpc_loop_condensed(pp, pc, ps, x0, 20)
    assert torch.equal(fused.iters, cond.iters)
    torch.testing.assert_close(fused.us, cond.us, atol=1e-5, rtol=0)
    torch.testing.assert_close(fused.xs, cond.xs, atol=1e-5, rtol=0)


def test_fused_loop_with_baked_references_and_state_bound():
    """References baked into the maps: the cold first step (d = 0) and the
    warm later ones both agree with the condensed loop; the state bound runs
    the kernel's generic state-dual path."""
    _, (pp, pc) = _cartpole(F64, x_bound=CART_X_BOUND, refs=_random_refs())
    ps = P.Settings(max_iter=200, check_termination=2)
    x0 = torch.as_tensor(_fused_x0()[:6])
    fused = pmpc.run_mpc_loop_fused(pp, pc, ps, x0, 6)
    cond = pmpc.run_mpc_loop_condensed(pp, pc, ps, x0, 6)
    assert torch.equal(fused.iters, cond.iters)
    assert bool((fused.iters % 2 == 0).all())
    torch.testing.assert_close(fused.us, cond.us, atol=1e-9, rtol=0)


def test_fused_loop_takes_an_injected_solver():
    """``fused=`` runs the same loop on a given solver: the plain version,
    counted here, is called once per step, cold then warm."""
    _, (pp, pc) = _cartpole(F32)
    ps = P.Settings(max_iter=50, en_state_bound=False)
    calls = []

    def counted(*args, **kw):
        calls.append((kw["warm_start"], args[7] is not None))
        return condensed_fused_reference(*args, **kw)

    x0 = torch.as_tensor(_fused_x0()[:4], dtype=torch.float32)
    res = pmpc.run_mpc_loop_fused(pp, pc, ps, x0, 5, fused=counted)
    assert calls == [(False, False)] + [(True, True)] * 4
    ref = pmpc.run_mpc_loop_fused(pp, pc, ps, x0, 5)
    assert torch.equal(res.us, ref.us) and torch.equal(res.iters, ref.iters)


@pytest.mark.parametrize("settings,match", [
    (dict(adaptive_rho=True), "box constraints and fixed rho"),
    (dict(en_input_soc=True), "box constraints and fixed rho"),
    (dict(check_termination=0), "never check"),
    (dict(max_iter=100, check_termination=3), "divide max_iter"),
])
def test_fused_loop_refuses_what_it_does_not_take(settings, match):
    _, (pp, pc) = _cartpole(F32)
    with pytest.raises(ValueError, match=match):
        pmpc.make_fused_mpc_loop(pp, pc, P.Settings(**settings), 5)


def test_the_port_imports_no_jax():
    code = ("import sys, tinympc_julia_tpu_torch\n"
            "import tinympc_julia_tpu_torch.parallel.mpc\n"
            "import tinympc_julia_tpu_torch.ops.cuda.fused\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tinympc_julia_tpu')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root)
