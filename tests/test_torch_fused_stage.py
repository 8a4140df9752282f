"""Kernel K3's plain version (``ops/cuda/fused.fused_reference``) against the
JAX ``make_fused_solver`` run in Pallas interpret mode, in float32: equal
per-lane iteration counts and ``solved`` flags, states and controls within
1e-5 on lanes both solve (fp32 sums taken in another order; nothing else
differs).  Also against the port's own reference-ordered ``solve_batch``,
and the Python side of the kernel's launch: the plan (lane group, tile,
shared memory) and the names of the kernel's variants."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tinympc_julia_tpu as J
import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu.models import cartpole, quadrotor, rocket
from tinympc_julia_tpu.ops.pallas import make_fused_solver as jax_make
from tinympc_julia_tpu_torch.ops.cuda import fused as K3
from tinympc_julia_tpu_torch.parallel import batch as PB

from torch_port_common import CPU, INTERPRET, port_copies

F32 = jnp.float32
ATOL = 1e-5


def _problem(model, N, ub, rho, *, dtype=F32, x_bound=None, f=None,
             refs=None):
    """(JAX problem, cache) and the port's copies."""
    kw = {}
    if x_bound is not None:
        xb = np.tile(x_bound, (N, 1))
        kw = dict(x_min=jnp.asarray(-xb, dtype), x_max=jnp.asarray(xb, dtype))
    if f is not None:
        kw["f"] = jnp.asarray(f, dtype)
    if refs is not None:
        kw.update(Xref=jnp.asarray(refs[0], dtype),
                  Uref=jnp.asarray(refs[1], dtype))
    jp = J.make_problem(jnp.asarray(model.A, dtype),
                        jnp.asarray(model.B, dtype),
                        jnp.asarray(np.diag(model.Q_DIAG), dtype),
                        jnp.asarray(np.diag(model.R_DIAG), dtype), rho, N,
                        u_min=-ub, u_max=ub, **kw)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(rho, dtype))
    return (jp, jc), port_copies(jp, jc, dtype)


def _args(p, c, x0s):
    """The solve_fn argument list of either package."""
    return (p.A, p.B, p.f, p.Q, p.R, c.rho, c.Kinf, c.Quu_inv, c.AmBKt,
            c.Pinf, p.x_min, p.x_max, p.u_min, p.u_max, p.Xref, p.Uref, x0s)


def _x0(B, nx, seed, scale):
    return np.random.default_rng(seed).uniform(-scale, scale, size=(B, nx))


def _rocket_refs(N):
    rng = np.random.default_rng(7)
    return (rng.normal(scale=0.05, size=(N, 6)),
            rng.normal(scale=0.02, size=(N - 1, 3)))


CASES = {
    # the inputs of tests/test_pallas_fused.py::test_fused_matches_xla
    "cartpole_ct1": dict(model=cartpole, N=20, ub=5.0, rho=1.0, B=256,
                         tile=128, seed=0, scale=0.5, kw=dict(max_iter=60)),
    "cartpole_ct4": dict(model=cartpole, N=20, ub=5.0, rho=1.0, B=256,
                         tile=128, seed=0, scale=0.5,
                         kw=dict(max_iter=60, check_termination=4)),
    # the cart position held to |x_0| <= 0.3: the bound binds on the lanes
    # that start fast, which do not converge in this budget and report their
    # last slacks, so this case compares every lane
    "cartpole_state_box": dict(model=cartpole, N=20, ub=5.0, rho=1.0, B=64,
                               tile=64, seed=1, scale=0.5,
                               x0_scale=np.array([0.5, 2.0, 1.0, 1.0]),
                               x_bound=np.array([0.3, 1e17, 1e17, 1e17]),
                               kw=dict(max_iter=120, en_state_bound=True)),
    # the rocket's affine term and non-zero references, box only
    "rocket_affine_refs": dict(model=rocket, N=10, ub=50.0, rho=1.0, B=64,
                               tile=64, seed=2, scale=0.5, f=rocket.F,
                               refs=_rocket_refs(10), kw=dict(max_iter=80)),
    "quadrotor_narrow": dict(model=quadrotor, N=20, ub=0.5, rho=5.0, B=32,
                             tile=32, seed=1, scale=0.2,
                             kw=dict(max_iter=150)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_interpret(name):
    cs = CASES[name]
    (jp, jc), (pp, pc) = _problem(cs["model"], cs["N"], cs["ub"], cs["rho"],
                                  x_bound=cs.get("x_bound"), f=cs.get("f"),
                                  refs=cs.get("refs"))
    nx, nu, N, B = jp.nx, jp.nu, cs["N"], cs["B"]
    x0 = _x0(B, nx, cs["seed"], cs["scale"]) * cs.get("x0_scale", 1.0)
    kw = dict(en_input_bound=True, en_state_bound=False)
    kw.update(cs["kw"])
    jfn = jax_make(nx, nu, N, batch_tile=cs["tile"], interpret=INTERPRET,
                   **kw)
    jx, ju, jit_, jok = (np.asarray(a) for a in jfn(
        *_args(jp, jc, jnp.asarray(x0, F32))))
    pfn = K3.make_fused_solver(nx, nu, N, **kw)
    px, pu, pit, pok = (a.numpy() for a in pfn(
        *_args(pp, pc, torch.as_tensor(x0, dtype=torch.float32))))
    np.testing.assert_array_equal(pit, jit_)
    np.testing.assert_array_equal(pok, jok)
    both = (pok == 1) & (jok == 1)
    assert both.sum() >= B // 2
    np.testing.assert_allclose(pu[both], ju[both], atol=ATOL, rtol=0)
    np.testing.assert_allclose(px[both], jx[both], atol=ATOL, rtol=0)
    if name == "cartpole_ct4":
        assert (pit[pok == 1] % 4 == 0).all()
    if name == "cartpole_state_box":
        np.testing.assert_allclose(pu, ju, atol=ATOL, rtol=0)
        np.testing.assert_allclose(px, jx, atol=ATOL, rtol=0)
        at_bound = np.abs(px[..., 0]).max(axis=1) == np.float32(0.3)
        assert at_bound.sum() >= 4 and not at_bound[both].any()
        assert np.abs(px[..., 0]).max() == np.float32(0.3)


@pytest.mark.parametrize("state_bound", [False, True],
                         ids=["box-free", "state-box"])
def test_wide_plant_matches_jax_interpret(state_bound):
    """The 20-state chain (nx = 20, nu = 9: the card runs the wide variant
    there) against ``make_fused_solver(20, 9, 8)`` in interpret mode, B =
    64: equal counts and flags, 1e-5 on the lanes both solve (with the
    state box |x| <= 0.6, every lane)."""
    import types
    from torch_port_common import chain_plant, chain_x0
    A, B = chain_plant()
    chain = types.SimpleNamespace(A=A, B=B, Q_DIAG=np.ones(20),
                                  R_DIAG=np.ones(9))
    xb = np.full(20, 0.6) if state_bound else None
    (jp, jc), (pp, pc) = _problem(chain, 8, 1.0, 1.0, x_bound=xb)
    x0 = chain_x0(64, 14)
    if state_bound:
        x0 = np.clip(x0, -0.5, 0.5)
    kw = dict(en_input_bound=True, en_state_bound=state_bound, max_iter=100)
    jfn = jax_make(20, 9, 8, batch_tile=32, interpret=INTERPRET, **kw)
    jx, ju, jit_, jok = (np.asarray(a) for a in jfn(
        *_args(jp, jc, jnp.asarray(x0, F32))))
    px, pu, pit, pok = (a.numpy() for a in K3.make_fused_solver(
        20, 9, 8, **kw)(*_args(pp, pc, torch.as_tensor(x0,
                                                       dtype=torch.float32))))
    np.testing.assert_array_equal(pit, jit_)
    np.testing.assert_array_equal(pok, jok)
    both = (pok == 1) & (jok == 1)
    assert both.sum() >= 32
    sel = slice(None) if state_bound else both
    np.testing.assert_allclose(pu[sel], ju[sel], atol=ATOL, rtol=0)
    np.testing.assert_allclose(px[sel], jx[sel], atol=ATOL, rtol=0)
    assert K3.fused_stage_plan(20, 9, 8, state_bound, 64, 132).group == 8


def _solve_batch(pp, pc, x0, **settings):
    st = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(pp.nx, pp.nu, pp.N, device=CPU, dtype=pp.dtype),
        x0.shape[0]), x0)
    return PB.solve_batch(pp, pc, P.Settings(**settings), st)[2]


@pytest.mark.parametrize("B", [37, 256])
@pytest.mark.parametrize("state_bound", [False, True])
def test_plain_version_matches_the_ports_solve_batch(B, state_bound):
    """The same ADMM as the reference-ordered batched solve; 37 lanes are no
    multiple of any tile."""
    xb = np.array([0.3, 1e17, 1e17, 1e17]) if state_bound else None
    _, (pp, pc) = _problem(cartpole, 20, 5.0, 1.0, x_bound=xb)
    x0 = torch.as_tensor(_x0(B, 4, 3, 0.5), dtype=torch.float32)
    kw = dict(max_iter=100, en_state_bound=state_bound)
    fn = K3.make_fused_solver(4, 1, 20, **kw)
    xs, us, it, ok = fn(*_args(pp, pc, x0))
    sol = _solve_batch(pp, pc, x0, **kw)
    assert torch.equal(it, sol.iter) and torch.equal(ok, sol.solved)
    both = ok == 1
    assert int(both.sum()) > (B // 8 if state_bound else B // 2)
    torch.testing.assert_close(us[both], sol.u[both], atol=ATOL, rtol=0)
    torch.testing.assert_close(xs[both], sol.x[both], atol=ATOL, rtol=0)


def test_plain_version_in_float64_matches_solve_batch_tightly():
    """Any float dtype: in float64 the two paths agree to 1e-10 on every
    lane, solved or not."""
    _, (pp, pc) = _problem(rocket, 10, 50.0, 1.0, dtype=jnp.float64,
                           f=rocket.F, refs=_rocket_refs(10))
    x0 = torch.as_tensor(_x0(24, 6, 5, 0.5))
    kw = dict(max_iter=40, en_state_bound=False)
    xs, us, it, ok = K3.make_fused_solver(6, 3, 10, **kw)(*_args(pp, pc, x0))
    sol = _solve_batch(pp, pc, x0, **kw)
    assert xs.dtype == torch.float64
    assert torch.equal(it, sol.iter) and torch.equal(ok, sol.solved)
    torch.testing.assert_close(us, sol.u, atol=1e-10, rtol=0)
    torch.testing.assert_close(xs, sol.x, atol=1e-10, rtol=0)


def test_unsolved_lanes_report_their_last_slacks():
    """A lane that never passes: ``iters == max_iter``, ``solved == 0`` and
    the slacks of the last iteration (those of a run one iteration longer
    differ; those of ``solve_batch`` at the same budget are equal)."""
    _, (pp, pc) = _problem(cartpole, 20, 5.0, 1.0)
    x0 = torch.as_tensor(_x0(64, 4, 4, 0.5), dtype=torch.float32)
    xs, us, it, ok = K3.make_fused_solver(4, 1, 20, max_iter=7)(
        *_args(pp, pc, x0))
    lost = ok == 0
    assert 0 < int(lost.sum()) < 64
    assert bool((it[lost] == 7).all()) and bool((it[~lost] < 8).all())
    sol = _solve_batch(pp, pc, x0, max_iter=7, en_state_bound=False)
    assert torch.equal(ok, sol.solved)
    torch.testing.assert_close(us[lost], sol.u[lost], atol=ATOL, rtol=0)
    torch.testing.assert_close(xs[lost], sol.x[lost], atol=ATOL, rtol=0)
    longer = K3.make_fused_solver(4, 1, 20, max_iter=8)(*_args(pp, pc, x0))
    still = lost & (longer[3] == 0)
    assert float((longer[1] - us)[still].abs().max()) > 1e-4


def test_input_bound_can_be_switched_off():
    _, (pp, pc) = _problem(cartpole, 20, 0.5, 1.0)
    x0 = torch.as_tensor(_x0(16, 4, 6, 0.5), dtype=torch.float32)
    kw = dict(max_iter=30, en_input_bound=False)
    xs, us, it, ok = K3.make_fused_solver(4, 1, 20, **kw)(*_args(pp, pc, x0))
    assert float(us.abs().max()) > 0.5  # the bound would have been active
    sol = _solve_batch(pp, pc, x0, en_state_bound=False, **kw)
    assert torch.equal(it, sol.iter) and bool((ok == 1).all())
    torch.testing.assert_close(us, sol.u, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nx,nu,N,state_bound", [
    (4, 1, 20, False), (4, 1, 20, True), (6, 3, 10, False),
    (12, 4, 20, False), (5, 2, 7, True)])
def test_stage_plan_follows_the_kernels_layout(nx, nu, N, state_bound):
    """The launch layout at each shape: the lane group and the matrices'
    place of the variant the build holds (the generic one for 5 x 2), whole
    warps of threads, the shared memory the kernel's layout needs (per-stage
    terms, the generic variant's matrices with rows padded to an odd
    stride, each lane's workspace at a stride that puts a warp's threads on
    32 banks), two blocks an SM where a warp of lanes allows it."""
    for batch in (1, 37, 4096, 65536):
        plan = K3.fused_stage_plan(nx, nu, N, state_bound, batch, 132)
        G, regs = K3.VARIANTS.get((nx, nu), K3.GENERIC)
        assert (plan.group, plan.registers) == (G, regs)
        assert plan.threads == plan.tile * G and plan.threads % 32 == 0
        assert 32 <= plan.threads <= K3.MAX_THREADS
        ls = K3.lane_stride(plan.tile, G)
        assert ls >= plan.tile and ls % 32 == (32 // G) % 32
        # a warp's G threads a lane, each on its own row: 32 banks
        banks = {(t * ls + lane) % 32 for t in range(G)
                 for lane in range(32 // G)}
        assert len(banks) == 32
        sx, su = N * nx, (N - 1) * nu
        stage = sx + 3 * su + (2 * sx if state_bound else 0)
        lx, lu = nx | 1, nu | 1
        mats = 0 if regs else nx * (2 * lx + 2 * lu) + nu * (2 * lx + lu)
        per_lane = (2 if state_bound else 1) * sx + 3 * su
        assert plan.smem == 4 * (stage + mats + per_lane * ls)
        if plan.threads > 32:
            assert 2 * plan.smem <= K3.SMEM_PER_BLOCK
            assert -(-batch // plan.tile) >= 132


def test_tile_plan():
    """The lane group of each plant shape, a block of MAX_THREADS threads
    halved until the grid covers the SMs (never below one warp), and the two
    refusals."""
    plan = K3.fused_stage_plan(4, 1, 20, False, 65536, 132)
    assert plan == K3.StagePlan(1, 128, 128, 4 * (137 + 137 * 128), True)
    assert K3.lane_floats(4, 1, 20, True) == 217
    assert K3.lane_floats(12, 4, 20, False) == 468
    assert K3.lane_floats(12, 4, 20, True) == 708
    q = K3.fused_stage_plan(12, 4, 20, False, 16384, 132)
    assert (q.group, q.tile, q.threads) == (4, 32, 128) and q.registers
    assert q.smem == 4 * (240 + 3 * 76 + 468 * 40)
    assert K3.fused_stage_plan(4, 1, 20, False, 512, 132).tile == 32
    assert K3.fused_stage_plan(4, 1, 20, False, 132 * 64, 132).tile == 64
    assert K3.fused_stage_plan(12, 4, 20, False, 1000, 132).tile == 8
    # the generic variant: G = 4, the matrices in shared memory beside the
    # per-stage terms
    gen = K3.fused_stage_plan(5, 2, 20, False, 16384, 132)
    assert (gen.group, gen.tile, gen.threads, gen.registers) == (
        4, 32, 128, False)
    assert gen.smem == 4 * (K3.stage_floats(5, 2, 20, False)
                            + K3.matrix_floats(5, 2)
                            + K3.lane_floats(5, 2, 20, False) * 40)
    # beyond the generic variant's 16: the wide variant (lane groups of 8
    # threads up to 32 rows, the stage vectors in shared memory); a warp of
    # lanes' workspace beyond shared memory: the far layout
    wide = K3.fused_stage_plan(17, 1, 20, False, 64, 132)
    assert (wide.group, wide.registers, wide.workspace_global) == (
        8, False, False)
    assert wide.smem == 4 * (K3.stage_floats(17, 1, 20, False)
                             + K3.matrix_floats(17, 1)
                             + K3.vec_floats(17, 1) * wide.tile
                             + K3.lane_floats(17, 1, 20, False)
                             * K3.lane_stride(wide.tile, 8))
    far = K3.fused_stage_plan(16, 16, 200, True, 64, 132)
    assert (far.group, far.registers, far.workspace_global,
            far.stage_global) == (4, False, True, False)
    assert far.smem == 4 * (K3.stage_floats(16, 16, 200, True)
                            + K3.matrix_floats(16, 16)
                            + K3.ring_stride(16, 16, True, far.ring, 4)
                            * far.tile)


def _parent_far_smem(nx, nu, N, box, tile, sg=False, mg=False):
    """The far plan's shared memory without its ring: the per-stage terms
    and the matrices unless in global memory, the wide variant's vectors."""
    group, regs = K3.lane_group(nx, nu)
    wide = max(nx, nu) > K3.GENERIC_DIM
    return 4 * ((0 if sg else K3.stage_floats(nx, nu, N, box))
                + (0 if mg or regs else K3.matrix_floats(nx, nu))
                + (K3.vec_floats(nx, nu) * tile if wide else 0))


@pytest.mark.parametrize("nx,nu,N,box,batch", [
    (12, 4, 300, False, 16384), (12, 4, 300, True, 16384),
    (4, 1, 4000, True, 300), (6, 3, 900, False, 4096),
    (5, 2, 700, True, 1001), (20, 9, 200, True, 64),
    (96, 96, 4, False, 64)])
def test_far_plan_holds_a_ring_beside_the_parents_layout(nx, nu, N, box,
                                                         batch):
    """The far layout at shapes whose workspace leaves shared memory: the
    ring of each lane group in ``smem`` beside what the layout kept before
    (the per-stage terms, the matrices, the wide variant's vectors, the
    same choices of what leaves for global memory), its depth the deepest
    up to MAX_RING that keeps the blocks an SM of the plan without it."""
    plan = K3.fused_stage_plan(nx, nu, N, box, batch, 132)
    assert plan.workspace_global
    assert K3.MIN_RING <= plan.ring <= K3.MAX_RING
    ring = K3.ring_stride(nx, nu, box, plan.ring, plan.group)
    assert plan.smem == _parent_far_smem(nx, nu, N, box, plan.tile,
                                         plan.stage_global,
                                         plan.matrices_global) \
        + 4 * ring * plan.tile
    assert plan.smem <= K3.SMEM_PER_BLOCK
    bare = plan._replace(smem=plan.smem - 4 * ring * plan.tile, ring=0)
    blocks = K3.estimated_blocks(bare)
    if plan.ring > K3.MIN_RING:
        assert K3.estimated_blocks(plan) >= blocks
    if plan.ring < K3.MAX_RING:  # one deeper would cost a block or not fit
        deeper = plan.smem + 4 * plan.tile * (K3.ring_stride(
            nx, nu, box, plan.ring + 1, plan.group) - ring)
        assert deeper > K3.SMEM_PER_BLOCK or K3.estimated_blocks(
            plan._replace(smem=deeper)) < blocks
    # a record holds v, g (under the box), z, y, d in whole 16-byte pieces;
    # a ring, whole records at an odd multiple of max(G, 4) floats
    rec = K3.record_floats(nx, nu, box)
    assert rec % 4 == 0 and 0 <= rec - ((2 if box else 1) * nx + 3 * nu) < 4
    assert ring >= plan.ring * rec and ring % 4 == 0
    if plan.group < 32:
        q = max(plan.group, 4)
        assert ring % q == 0 and (ring // q) % 2 == 1


def test_far_plan_keeps_the_grid_and_weighs_the_card():
    """The far plan's lane slots never fall below the ringless layout's:
    where the card holds two blocks an SM by their registers (the
    quadrotor's far instances, 222 registers) the ring deepens to MAX_RING
    in both the free and the boxed plan, and a ``resident`` that loses a
    block to any ring keeps the shallowest.  The workspace is ``N``
    records for each of the grid's lane slots; ``far`` forces the layout
    where the near one fits."""
    for box in (False, True):
        def two(plan):
            return min(2, K3.SMEM_PER_SM // (plan.smem + K3.SMEM_RESERVED))
        plan = K3.fused_stage_plan(12, 4, 300, box, 16384, 132,
                                   resident=two)
        assert plan.ring == K3.MAX_RING and two(plan) == 2
        assert (plan.group, plan.tile, plan.threads) == (4, 32, 128)
        bare = K3.fused_stage_plan(12, 4, 300, box, 16384, 132,
                                   resident=lambda pl: 99 if pl.ring == 0
                                   else 1)
        assert bare.ring == K3.MIN_RING
        slots = 2 * 132 * plan.tile
        floats = slots * 300 * K3.record_floats(12, 4, box)
        assert floats >= slots * K3.lane_floats(12, 4, 300, box)
    assert K3.record_floats(12, 4, False) == 24
    assert K3.record_floats(12, 4, True) == 36
    near = K3.fused_stage_plan(12, 4, 173, True, 16384, 132)
    assert not near.workspace_global and near.ring == 0
    forced = K3.fused_stage_plan(12, 4, 173, True, 16384, 132, far=True)
    assert forced.workspace_global and not forced.stage_global
    assert forced.ring >= K3.MIN_RING
    # the wide variant's far plan with its matrices in global memory
    wide = K3.fused_stage_plan(96, 96, 4, False, 64, 132)
    assert (wide.group, wide.tile, wide.matrices_global,
            wide.stage_global) == (32, 1, True, False)
    assert wide.smem == 4 * (K3.stage_floats(96, 96, 4, False)
                             + K3.vec_floats(96, 96)
                             + K3.ring_stride(96, 96, False, wide.ring, 32))


@pytest.mark.parametrize("model", [cartpole, quadrotor, rocket])
def test_cache_is_row_major(model):
    """The kernel reads the cache's matrices as they are and refuses a
    strided one, so ``precompute_cache`` returns them contiguous (LAPACK's
    solve and inverse give column-major results)."""
    from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
    f32 = dict(dtype=torch.float32)
    A, B = torch.as_tensor(model.A, **f32), torch.as_tensor(model.B, **f32)
    c = precompute_cache(A, B, torch.as_tensor(model.Q_DIAG + 1.0, **f32),
                         torch.as_tensor(model.R_DIAG + 1.0, **f32), 1.0)
    for t in (c.Kinf, c.Pinf, c.Quu_inv, c.AmBKt):
        assert t.is_contiguous()
    torch.testing.assert_close(c.AmBKt, (A - B @ c.Kinf).T, rtol=0, atol=0)


def test_variant_labels_and_ptxas_usage():
    """The names chip_smoke.py prints for each K3 instance, and the
    registers and spills read from ``-Xptxas -v``."""
    from tinympc_julia_tpu_torch.ops.cuda._build import ptxas_usage
    name = ("_ZN12_GLOBAL__N_118fused_stage_kernelILi12ELi4ELi4ELb1ELb1ELb0E"
            "EEvNS_6ParamsE")
    log = (f"ptxas info    : Compiling entry function '{name}' for "
           f"'sm_90a'\nptxas info    : Function properties for {name}\n"
           "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
           "loads\nptxas info    : Used 168 registers, used 0 barriers\n")
    assert ptxas_usage(log) == {name: (168, 8, 4, 4)}
    assert K3.variant_label(name) == "12x4, G=4, registers, free"
    assert K3.variant_label(name.replace("ILi12ELi4ELi4ELb1ELb1ELb0E",
                                         "ILi0ELi0ELi4ELb0ELb0ELb0E")) == (
        "generic, G=4, shared, box")
    # the far layout (the workspace in global memory) and the wide variant
    assert K3.variant_label(name.replace("ELb0EEEv", "ELb1EEEv")) == (
        "12x4, G=4, registers, free, far")
    wide = ("_ZN12_GLOBAL__N_123fused_stage_wide_kernelILi8ELb0EEEv"
            "NS_6ParamsE")
    assert K3.variant_label(wide) == "wide, G=8, box"
    assert K3.variant_label("_Z3foov") is None


def test_factory_and_wrappers_refuse_what_they_do_not_take():
    _, (pp, pc) = _problem(cartpole, 20, 5.0, 1.0)
    x0 = torch.zeros((8, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="check_termination"):
        K3.make_fused_solver(4, 1, 20, check_termination=0)
    fn = K3.make_fused_solver(4, 1, 20)
    with pytest.raises(ValueError, match="x0s must be"):
        fn(*_args(pp, pc, x0[:, :3]))
    bad = list(_args(pp, pc, x0))
    bad[10] = bad[10][:-1]  # x_min one stage short
    with pytest.raises(ValueError, match="x_min must be"):
        fn(*bad)
    with pytest.raises(ValueError, match="no fused solver"):
        fn(*_args(pp, pc, x0.to("meta")))
    # the kernel's wrapper never runs a CPU tensor
    kw = dict(nx=4, nu=1, N=20, max_iter=5, abs_pri_tol=1e-3,
              abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
              check_termination=1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K3.fused_cuda(*_args(pp, pc, x0), **kw)
    assert K3.fused_cuda.launches == 0
