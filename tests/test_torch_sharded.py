"""The port's sharded solve (parallel/mesh.py, parallel/sharded.py) and its
dry run (dryrun.py) against the JAX package's, on a 2-rank gloo group of
CPU processes.

The cases of tests/test_sharding.py run on the ranks in one job
(tests/test_torch_sharded_ranks.py, which holds no tests of its own),
spawned once for the module through ``dryrun.run_ranks``: vote on and off,
float32 per block bit for bit, the output layout, adaptive rho, an
indivisible batch, the quadrotor.  This
process runs JAX ``solve_sharded`` on conftest's 8 virtual devices with the
same numpy inputs, and the ranks' blocks must match it: equal iteration
counts and solved flags, states and controls within 1e-12 in float64.  The
dry run's three legs run once too (``dryrun_multichip(2, device="cpu")``);
its pipeline leg's first phase is held against the JAX mesh pipeline of
tests/test_mesh_pipeline.py.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import tinympc_julia_tpu as J
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.ops.condensed import CondensedMaps
from tinympc_julia_tpu.ops.pallas.condensed_kernel import (
    make_condensed_fused_solver)
from tinympc_julia_tpu.parallel import (broadcast_state, make_mesh,
                                        set_x0_batch, shard_state,
                                        solve_sharded)
from tinympc_julia_tpu_torch import Settings as TSettings
from tinympc_julia_tpu_torch import dryrun, make_problem, precompute_cache
from tinympc_julia_tpu_torch import parallel as TP
from tinympc_julia_tpu_torch.ops.condensed import (
    build_condensed as build_condensed_port)

import test_torch_sharded_ranks as R

from torch_port_common import INTERPRET

WORLD = 2
TESTS = os.path.dirname(os.path.abspath(__file__))
JOB = "test_torch_sharded_ranks:run"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's saved blocks of the job, in rank order."""
    paths = dryrun.run_ranks(WORLD, JOB, device="cpu", timeout=300,
                             out_dir=tmp_path_factory.mktemp("ranks"),
                             path=[TESTS])
    return [dict(np.load(p)) for p in paths]


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """The dry run's legs on 2 ranks (each rank checks its legs bit for bit
    against its own run and fails the run otherwise)."""
    paths = dryrun.dryrun_multichip(WORLD, device="cpu", timeout=300,
                                    out_dir=tmp_path_factory.mktemp("dry"))
    return [dict(np.load(p)) for p in paths]


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=0)


def _jax_sharded(settings, B, seed, vote=True):
    p = J.make_problem(jnp.asarray(cartpole.A), jnp.asarray(cartpole.B),
                       jnp.asarray(np.diag(cartpole.Q_DIAG)),
                       jnp.asarray(np.diag(cartpole.R_DIAG)), 1.0, R.N,
                       u_min=-0.7, u_max=0.7)
    c = J.precompute_cache(p.A, p.B, p.Q, p.R, jnp.asarray(1.0, p.A.dtype))
    st = set_x0_batch(broadcast_state(J.init_state(4, 1, R.N, p.A.dtype), B),
                      jnp.asarray(R.x0s(B, seed)))
    mesh = make_mesh()
    assert mesh.shape["batch"] == 8, "conftest provides 8 virtual devices"
    return solve_sharded(p, c, J.Settings(**settings), shard_state(st, mesh),
                         mesh, vote=vote)


def _assert_matches_jax(ranks, prefix, jsol):
    np.testing.assert_array_equal(_cat(ranks, f"{prefix}_iter"),
                                  np.asarray(jsol.iter))
    np.testing.assert_array_equal(_cat(ranks, f"{prefix}_solved"),
                                  np.asarray(jsol.solved))
    for k in ("x", "u"):
        np.testing.assert_allclose(_cat(ranks, f"{prefix}_{k}"),
                                   np.asarray(getattr(jsol, k)), atol=1e-12,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("vote", [1, 0])
def test_sharded_matches_local_and_jax(ranks, vote):
    """Each rank's block equals its block solved by ``solve_batch`` bit for
    bit, and the blocks together match JAX ``solve_sharded`` (vote on:
    every rank loops until all lanes converge; off: each alone)."""
    for r in ranks:
        for k in ("iter", "solved", "x", "u"):
            np.testing.assert_array_equal(r[f"vote{vote}_{k}"],
                                          r[f"local64_{k}"], err_msg=k)
    _, _, jsol = _jax_sharded(R.BASE, 64, 0, vote=bool(vote))
    _assert_matches_jax(ranks, f"vote{vote}", jsol)


def test_sharded_bitwise_f32(ranks):
    """float32: the sharded block equals the block's own solve to the bit;
    the vote adds no numerical effect."""
    assert sum(int(r["f32_solved"].sum()) for r in ranks) > 0
    for r in ranks:
        for k in ("iter", "solved", "x", "u"):
            np.testing.assert_array_equal(r[f"f32_{k}"], r[f"local32_{k}"],
                                          err_msg=k)


def test_sharded_output_layout(ranks):
    """The outputs are the rank's blocks on its device, with no gather; the
    replicated cache stays whole."""
    for r in ranks:
        assert tuple(r["layout_state"]) == (32 // WORLD, R.N, 4)
        assert tuple(r["layout_x"]) == (32 // WORLD, R.N, 4)
        assert tuple(r["layout_rho"]) == ()
        assert list(r["layout_devices"]) == [str(r["device"])] == ["cpu"]


def test_sharded_adaptive_rho(ranks):
    """Adaptive rho: the cache comes back per instance for the block, and
    the blocks' rhos and solves match JAX's within 1e-12."""
    for r in ranks:
        assert r["adaptive_rho"].shape == (16 // WORLD,)
    _, jcache, jsol = _jax_sharded(R.ADAPTIVE, 16, 9)
    np.testing.assert_allclose(_cat(ranks, "adaptive_rho"),
                               np.asarray(jcache.rho), atol=1e-12, rtol=0)
    assert np.any(_cat(ranks, "adaptive_rho") != 1.0)
    _assert_matches_jax(ranks, "adaptive", jsol)


def test_indivisible_batch_raises_on_every_rank(ranks):
    """B = 3 through ``shard_state`` and blocks of 2 and 1 through
    ``solve_sharded`` raise the JAX package's error on both ranks, and the
    job goes on (no rank is left waiting in a collective)."""
    for r in ranks:
        assert list(r["errors"]) == ["batch 3 not divisible by mesh size "
                                     "2"] * 2


def test_quadrotor_sharded(ranks):
    """The flagship 12-state model: every lane solves within its bounds."""
    assert all(np.all(r["quad_solved"] == 1) for r in ranks)
    assert all(np.all(np.abs(r["quad_u"]) <= 0.5 + 1e-9) for r in ranks)


def test_world_of_one_equals_solve_batch():
    """Without a process group the mesh is a world of one on the given
    device, and the sharded solve is ``solve_batch`` to the bit."""
    mesh = TP.make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    p, c = R.cartpole_problem(torch.float64, mesh.device)
    st = R.batch(R.x0s(8, 0), torch.float64, mesh.device)
    settings = TSettings(**R.BASE)
    block = TP.shard_state(st, mesh)
    _, _, sol = TP.solve_sharded(p, c, settings, block, mesh)
    _, _, ref = TP.solve_batch(p, c, settings, st)
    for k in ("iter", "solved", "x", "u"):
        assert torch.equal(getattr(sol, k), getattr(ref, k)), k
    out = TP.map_shards(lambda x: x * 2, mesh, st.x)
    assert torch.equal(out, st.x * 2)


def test_make_mesh_has_no_cpu_fallback():
    """With no CUDA and no device, ``make_mesh`` raises; the size of the
    world must be the one asked for."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.make_mesh(device=device)
    with pytest.raises(ValueError, match="2 devices"):
        TP.make_mesh(2, device="cpu")


def _jax_mesh_pipeline_phase1(B, slots_a_shard):
    """(us1, it1, ok1) of the first phase of tests/test_mesh_pipeline.py's
    two-phase chain under ``shard_map`` on the 8 virtual devices, on the
    maps the port's dry run builds (tests/test_torch_condensed.py holds the
    two packages' maps against each other), as
    tests/test_torch_condensed_kernel.py gives both kernels the same maps."""
    dtype = jnp.float32
    p = J.make_problem(jnp.asarray(cartpole.A, dtype),
                       jnp.asarray(cartpole.B, dtype),
                       jnp.asarray(np.diag(cartpole.Q_DIAG), dtype),
                       jnp.asarray(np.diag(cartpole.R_DIAG), dtype),
                       cartpole.RHO, R.N, u_min=-5.0, u_max=5.0)
    c = J.precompute_cache(p.A, p.B, p.Q, p.R,
                           jnp.asarray(cartpole.RHO, dtype))
    tp = make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                      np.diag(cartpole.R_DIAG), cartpole.RHO, R.N,
                      u_min=-5.0, u_max=5.0, dtype=torch.float32,
                      device="cpu")
    tmaps = build_condensed_port(tp, precompute_cache(tp.A, tp.B, tp.Q, tp.R,
                                                      tp.rho_setup))
    maps = CondensedMaps(*(jnp.asarray(t.numpy()) for t in tmaps))
    kw = dict(en_input_bound=True, en_state_bound=False,
              relaxation_alpha=1.7, check_termination=4, interpret=INTERPRET)
    fn1 = make_condensed_fused_solver(4, 1, R.N, batch_tile=8, max_iter=20,
                                      carry_out=True, **kw)
    fn2 = make_condensed_fused_solver(4, 1, R.N, batch_tile=8, max_iter=40,
                                      warm_start=True, **kw)
    bounds = (p.u_min, p.u_max, p.x_min, p.x_max)

    def pipeline(x0s):
        _, us1, it1, ok1, carry = fn1(maps, c.rho, *bounds, x0s)
        idx = jnp.nonzero(ok1 == 0, size=slots_a_shard, fill_value=0)[0]
        warm = tuple(w[:, idx] for w in carry)
        fn2(maps, c.rho, *bounds, x0s[idx], warm)
        return us1, it1, ok1

    mesh = Mesh(np.asarray(jax.devices()), ("batch",))
    x0s = np.random.default_rng(0).uniform(-0.5, 0.5, size=(B, 4))
    out = jax.jit(shard_map(pipeline, mesh=mesh, in_specs=P("batch"),
                            out_specs=(P("batch"),) * 3, check_vma=False))(
        jnp.asarray(x0s, dtype))
    return [np.asarray(o) for o in out]


def test_dryrun_pipeline_leg_matches_jax_mesh_pipeline(dry):
    """Leg 2 (B = 64, 32 slots a rank, 20 + 40 iterations on the plain K1,
    bit for bit per rank in the ranks): its first phase against the JAX
    mesh pipeline's at the bar of test_torch_condensed_kernel.py (on the
    lanes both solved, identical counts and controls within 1e-5)."""
    us, it1, ok1 = (_cat(dry, f"l2_{k}") for k in ("us", "iters1",
                                                   "solved1"))
    assert us.shape[0] == 64 and all(int(r["l2_unconv"].sum()) > 0
                                     for r in dry)
    jus1, jit1, jok1 = _jax_mesh_pipeline_phase1(64, 8)
    # a lane solved in phase 1 keeps its phase-1 controls in the merge
    both = (ok1 == 1) & (jok1 == 1)
    assert both.sum() > 0
    np.testing.assert_array_equal(it1[both], jit1[both])
    np.testing.assert_allclose(us[both], jus1[both], atol=1e-5)


def test_dryrun_legs(dry):
    """Leg 1 solved some lanes; leg 3 moved rho off rho0 and converged
    lanes; on the CPU no kernel was launched (the plain versions ran), so
    legs 2 and 3 equal their runs on the plain version to the bit."""
    assert all(r["l1_iter"].shape == (2,) for r in dry)
    assert sum(int(r["l1_solved"].sum()) for r in dry) > 0
    for r in dry:
        assert int(r["l3_solved"].sum()) > 0 and r["l3_rho"].max() > 0.01
        assert r["l2_k1_launches"] == r["l3_k1_launches"] == 0
        for leg in ("l2", "l3"):
            assert r[f"{leg}_plain_share"] == 1.0
            assert r[f"{leg}_plain_err"] == 0.0


def test_dryrun_entry():
    """``entry`` gives the batched quadrotor solve and its arguments."""
    fn, args = dryrun.entry("cpu")
    u, iters, solved = fn(*args)
    assert tuple(u.shape) == (64, 19, 4) and u.dtype == torch.float32
    assert int(solved.sum()) > 0 and int(iters.max()) <= 50
    assert float(u.abs().max()) <= 0.5 + 1e-6


def test_run_ranks_fails_with_a_rank():
    """A rank that raises fails the run in the caller, with its log."""
    with pytest.raises(RuntimeError, match=r"rank \d exited with 1"):
        dryrun.run_ranks(WORLD, "test_torch_sharded_ranks:missing",
                         device="cpu", timeout=120, path=[TESTS])
