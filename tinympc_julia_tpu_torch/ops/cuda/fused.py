"""Kernel K3: the per-stage (uncondensed) box-constrained ADMM solve, fused
(counterpart of tinympc_julia_tpu/ops/pallas/fused.py).

``make_fused_solver`` returns ``solve_fn(A, B, f, Qd, Rd, rho, Kinf, Quu_inv,
AmBKt, Pinf, x_min, x_max, u_min, u_max, Xref, Uref, x0s)``.  On CUDA tensors
it launches the hand-written kernel ``csrc/fused_stage.cu`` (``fused_cuda``)
or raises; on CPU tensors it runs the kernel's plain PyTorch version
(``fused_reference``).  There is no fallback from one to the other.

Scope, as the Pallas kernel's: one problem and one set of references shared
by the batch, fresh solves (zero workspace, per-lane x0), box constraints.
Per lane and iteration: the rollout ``u_k = -K x_k - d_k``, ``x_{k+1} = A x_k
+ B u_k + f``; the slacks ``zn = clip(u + y)``, ``vn = clip(x + g)``; the
duals ``y += u - zn``, ``g += x - vn``; the four max-abs residuals (the dual
ones against the previous slacks, times rho); a lane that passes on a
checking iteration latches its slacks, its count and ``solved = 1``; then
the linear cost ``r = rref - rho (zn - y)``, ``q = qref - rho (vn - g)``,
``p_{N-1} = pNref - rho (vn_{N-1} - g_{N-1})`` and the backward recursion
``d_k = Quu (B' p_{k+1} + r_k)``, ``p_k = q_k + AmBKt p_{k+1} - K' r_k``.  A
lane that never passes returns its last slacks, ``iters = max_iter``,
``solved = 0``.  Without a state bound the state dual stays 0 and ``vn = x``
exactly; kernel and plain version both drop ``g`` then.

General constraints, warm starts, over-relaxation and per-lane problems stay
on the condensed kernels and the reference-ordered path.
"""
from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch

from ...utils.precision import full_fp32_matmul
from ._build import load_library

# The launch layout is decided here and passed to the kernel, which checks
# it: shared memory one block may use on sm_90 (opt-in maximum, bytes), the
# widest nx, nu of the kernel's generic variant (csrc/fused_stage.cu
# kGenericDim) and the threads of a block the plan starts from.
SMEM_PER_BLOCK = 232448
GENERIC_DIM = 16
MAX_THREADS = 128
# What an H100 SM holds, for the far layout's estimate of its blocks an SM
# off the card: shared memory (bytes, and what the runtime reserves a
# block), threads, registers, blocks; and the registers a thread of a far
# instance may take (ptxas: 216-248).
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
THREADS_PER_SM = 2048
REGISTERS_PER_SM = 65536
BLOCKS_PER_SM = 32
FAR_REGISTERS = 255
# The far layout's ring: records of a lane a group keeps in shared memory
# (csrc/fused_stage.cu kMaxRing), one fewer in flight.
MIN_RING, MAX_RING = 2, 8

# The variants csrc/fused_stage.cu builds (its K3_VARIANTS): (nx, nu) ->
# (lane group, the matrices' rows in registers); any other shape up to
# GENERIC_DIM runs the generic variant, GENERIC.  A wider plant runs the
# wide variant with the first lane group of WIDE_GROUPS whose threads hold
# at most WIDE_ROWS rows of each stage vector (32 beyond that).
VARIANTS = {(4, 1): (1, True), (6, 3): (2, True), (12, 4): (4, True)}
GENERIC = (4, False)
WIDE_GROUPS = (8, 16, 32)
WIDE_ROWS = 4


class StagePlan(NamedTuple):
    group: int       # threads a lane
    tile: int        # lanes a block
    threads: int     # tile * group
    smem: int        # dynamic shared memory a block, bytes
    registers: bool  # the matrices' rows in registers (else shared memory)
    workspace_global: bool = False  # the lanes' workspace in global memory
    stage_global: bool = False      # ... and the per-stage terms
    matrices_global: bool = False   # the wide variant's matrices read from
                                    # the caller's tensors
    ring: int = 0                   # the far layout's records a lane group
                                    # keeps in shared memory


def reference_terms(Qd, Rd, Pinf, Xref, Uref):
    """(qref (N, nx), rref (N-1, nu), pNref (nx,)): the references' part of
    the linear cost, ``-Xref*Qd``, ``-Uref*Rd`` and ``-Pinf' Xref[-1]``."""
    return -(Xref * Qd), -(Uref * Rd), -(Pinf.T @ Xref[-1])


def lane_floats(nx: int, nu: int, N: int, en_state_bound: bool) -> int:
    """What a lane keeps across iterations: the slacks v, z, the duals y
    (and g under a state bound) and the feedforward d."""
    return (2 if en_state_bound else 1) * N * nx + 3 * (N - 1) * nu


def stage_floats(nx: int, nu: int, N: int, en_state_bound: bool) -> int:
    """A block's per-stage terms: qref, rref, u_min, u_max (and x_min,
    x_max under a state bound)."""
    sx, su = N * nx, (N - 1) * nu
    return sx + 3 * su + (2 * sx if en_state_bound else 0)


def matrix_floats(nx: int, nu: int) -> int:
    """The generic variant's matrices in shared memory: A, AmBKt, B, K'
    (nx rows), K, B', Quu (nu rows), each row padded to an odd stride."""
    lx, lu = nx | 1, nu | 1
    return nx * (2 * lx + 2 * lu) + nu * (2 * lx + lu)


def vec_floats(nx: int, nu: int) -> int:
    """The wide variant's stage vectors of a lane in shared memory: x_k,
    A x_k (or AmBKt p_{k+1}), p_{k+1}, u_k, s_k, r_k."""
    return 3 * nx + 3 * nu


def lane_group(nx: int, nu: int) -> tuple:
    """(lane group, the matrices' rows in registers) of the variant that
    solves this shape."""
    if max(nx, nu) <= GENERIC_DIM:
        return VARIANTS.get((nx, nu), GENERIC)
    return next((g for g in WIDE_GROUPS if max(nx, nu) <= WIDE_ROWS * g),
                WIDE_GROUPS[-1]), False


def record_floats(nx: int, nu: int, en_state_bound: bool) -> int:
    """The far layout's record of a lane and stage: v, g (under a state
    bound), z, y, d, padded to whole 16-byte pieces.  The workspace holds
    ``N`` records for each lane slot, laid out [warp slot][stage][lane of
    the warp][record]."""
    return -(-((2 if en_state_bound else 1) * nx + 3 * nu) // 4) * 4


def ring_stride(nx: int, nu: int, en_state_bound: bool, depth: int,
                group: int) -> int:
    """The far layout's ring of a lane group in shared memory: ``depth``
    records, padded to an odd multiple of max(group, 4) floats (a multiple
    of 4 at group 32), so that the rings of a warp's groups start on banks
    as far apart as 16-byte alignment allows."""
    n = depth * record_floats(nx, nu, en_state_bound)
    if group >= 32 or n == 0:
        return n
    q = max(group, 4)
    r = -(-n // q) * q
    return r if (r // q) % 2 else r + q


def estimated_blocks(plan: "StagePlan") -> int:
    """Blocks of ``plan`` an H100 SM holds, off the card: its shared
    memory, its threads and FAR_REGISTERS registers a thread."""
    return min(SMEM_PER_SM // (plan.smem + SMEM_RESERVED),
               THREADS_PER_SM // plan.threads,
               REGISTERS_PER_SM // (plan.threads * FAR_REGISTERS),
               BLOCKS_PER_SM)


def lane_stride(tile: int, group: int) -> int:
    """The workspace's lane stride: ``tile`` rounded up to be = 32 / group
    (mod 32), so that a warp's threads, each on its own row, fall on 32
    different banks."""
    return tile + (32 // group - tile) % 32


def fused_stage_plan(nx: int, nu: int, N: int, en_state_bound: bool,
                     batch: int, sm_count: int, *, far: bool = False,
                     resident=estimated_blocks) -> StagePlan:
    """The launch layout of kernel K3.

    The lane group and where the matrices live come from ``lane_group``.
    The tile is ``MAX_THREADS / group`` lanes, halved while two blocks do
    not fit an SM's shared memory and while the grid would leave SMs
    without a block, but never below one warp of threads.  Where a warp of
    lanes' workspace does not fit in shared memory (a long horizon), or
    with ``far``, the far layout: the workspace in global memory, streamed
    through a ring of each lane group's next records in shared memory, then
    (the wide variant) the matrices and the per-stage terms in global
    memory too while the rest does not fit beside the shallowest ring.  The
    ring is the deepest up to MAX_RING records that keeps the blocks an SM
    (``resident(plan)``: off the card ``estimated_blocks``, at a launch the
    occupancy API) of the plan without one.  It raises only where one
    lane's stage vectors alone exceed a block's shared memory (nx + nu
    above 19,370)."""
    group, registers = lane_group(nx, nu)
    wide = max(nx, nu) > GENERIC_DIM
    stage = stage_floats(nx, nu, N, en_state_bound)
    mats = 0 if registers else matrix_floats(nx, nu)
    vec = vec_floats(nx, nu) if wide else 0
    per_lane = lane_floats(nx, nu, N, en_state_bound)

    def smem(tile, far=False, sg=False, mg=False, ring=0):
        ws = (ring_stride(nx, nu, en_state_bound, ring, group) * tile if far
              else per_lane * lane_stride(tile, group))
        return 4 * ((0 if sg else stage) + (0 if mg else mats) + vec * tile
                    + ws)

    warp = 32 // group
    tile = max(MAX_THREADS // group, warp)
    while tile > warp and 2 * smem(tile) > SMEM_PER_BLOCK:
        tile //= 2
    sg = mg = False
    if far or smem(tile) > SMEM_PER_BLOCK:
        far = True
        tile = max(MAX_THREADS // group, warp)
        mg = wide and smem(tile, far, ring=MIN_RING) > SMEM_PER_BLOCK
        sg = smem(tile, far, False, mg, MIN_RING) > SMEM_PER_BLOCK
        while tile > warp and smem(tile, far, sg, mg, MIN_RING) \
                > SMEM_PER_BLOCK:
            tile //= 2
        if smem(tile, far, sg, mg, MIN_RING) > SMEM_PER_BLOCK:
            raise ValueError(f"fused per-stage kernel: nx={nx}, nu={nu} "
                             "leave no room for one lane's stage vectors in "
                             "shared memory")
    while tile > warp and -(-batch // tile) < sm_count:
        tile //= 2
    plan = StagePlan(group, tile, tile * group, smem(tile, far, sg, mg),
                     registers, far, sg, mg)
    if not far:
        return plan
    blocks = resident(plan)
    for ring in range(MAX_RING, MIN_RING, -1):
        deep = plan._replace(smem=smem(tile, far, sg, mg, ring), ring=ring)
        if deep.smem <= SMEM_PER_BLOCK and resident(deep) >= blocks:
            return deep
    return plan._replace(smem=smem(tile, far, sg, mg, MIN_RING),
                         ring=MIN_RING)


def _validate(args, nx, nu, N):
    """Shape and device checks shared by kernel and plain version."""
    (A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min, x_max, u_min,
     u_max, Xref, Uref, x0s) = args
    shapes = dict(A=(nx, nx), B=(nx, nu), f=(nx,), Qd=(nx,), Rd=(nu,),
                  Kinf=(nu, nx), Quu_inv=(nu, nu), AmBKt=(nx, nx),
                  Pinf=(nx, nx), x_min=(N, nx), x_max=(N, nx),
                  u_min=(N - 1, nu), u_max=(N - 1, nu), Xref=(N, nx),
                  Uref=(N - 1, nu))
    named = dict(A=A, B=B, f=f, Qd=Qd, Rd=Rd, Kinf=Kinf, Quu_inv=Quu_inv,
                 AmBKt=AmBKt, Pinf=Pinf, x_min=x_min, x_max=x_max,
                 u_min=u_min, u_max=u_max, Xref=Xref, Uref=Uref)
    if x0s.ndim != 2 or x0s.shape[1] != nx:
        raise ValueError(f"x0s must be (B, {nx}); got {tuple(x0s.shape)}")
    for name, t in named.items():
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}; got "
                             f"{tuple(t.shape)}")
    tensors = list(named.values()) + [x0s]
    if isinstance(rho, torch.Tensor):
        if rho.numel() != 1:
            raise ValueError(f"rho must be a scalar; got {tuple(rho.shape)}")
        tensors.append(rho)
    for t in tensors:
        if t.device != x0s.device:
            raise ValueError(f"all inputs must be on {x0s.device}; got one "
                             f"on {t.device}")
    return tensors


@full_fp32_matmul()
def fused_reference(A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min,
                    x_max, u_min, u_max, Xref, Uref, x0s, *, nx, nu, N,
                    max_iter, abs_pri_tol, abs_dua_tol, en_state_bound,
                    en_input_bound, check_termination):
    """Plain PyTorch version of kernel K3: the kernel's arithmetic step by
    step, on the whole batch at once, each per-stage product a ``matmul`` of
    an (nx, nx)-sized matrix with an (nx, B) stage slice (a lane's result
    does not depend on the other lanes).  Any float dtype and device.  A
    latched lane's outputs are held while the batch runs on; the loop ends
    when every lane has latched or at ``max_iter``."""
    _validate((A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min,
               x_max, u_min, u_max, Xref, Uref, x0s), nx, nu, N)
    dt, dev = x0s.dtype, x0s.device
    Bsz = x0s.shape[0]
    rho = torch.as_tensor(rho, dtype=dt, device=dev).reshape(())
    qref, rref, pNref = (t.unsqueeze(-1) for t in reference_terms(
        Qd, Rd, Pinf, Xref, Uref))                 # (N, nx, 1), ..., (nx, 1)
    fcol = f.unsqueeze(-1)
    BT, KT = B.T, Kinf.T
    xmin, xmax = x_min.unsqueeze(-1), x_max.unsqueeze(-1)
    umin, umax = u_min.unsqueeze(-1), u_max.unsqueeze(-1)
    pri_tol = torch.tensor(abs_pri_tol, dtype=dt, device=dev)
    dua_tol = torch.tensor(abs_dua_tol, dtype=dt, device=dev)
    state_free = not en_state_bound

    def zeros(*shape):
        return torch.zeros(shape + (Bsz,), dtype=dt, device=dev)

    def amax(t):
        return torch.amax(torch.abs(t), dim=(0, 1))

    x0 = x0s.T
    v, g = zeros(N, nx), zeros(N, nx)
    z, y, d = zeros(N - 1, nu), zeros(N - 1, nu), zeros(N - 1, nu)
    xout, uout = zeros(N, nx), zeros(N - 1, nu)
    conv = torch.zeros((Bsz,), dtype=torch.bool, device=dev)
    iters = torch.full((Bsz,), max_iter, dtype=torch.int32, device=dev)
    solved = torch.zeros((Bsz,), dtype=torch.int32, device=dev)

    for i in range(max_iter):
        # forward rollout
        xs, us = [x0], []
        for k in range(N - 1):
            u_k = -(Kinf @ xs[k]) - d[k]
            us.append(u_k)
            xs.append(A @ xs[k] + B @ u_k + fcol)
        x, u = torch.stack(xs), torch.stack(us)
        # slacks and duals
        zn = u + y
        if en_input_bound:
            zn = torch.minimum(umax, torch.maximum(umin, zn))
        y = y + u - zn
        if state_free:
            vn = x  # g == 0 and no projection
        else:
            vn = torch.minimum(xmax, torch.maximum(xmin, x + g))
            g = g + x - vn
        # residuals and the per-lane latch
        ps, pi = amax(x - vn), amax(u - zn)
        ds, di = amax(v - vn) * rho, amax(z - zn) * rho
        ok = (ps < pri_tol) & (pi < pri_tol) & (ds < dua_tol) & (di < dua_tol)
        if (i + 1) % check_termination != 0:
            ok = torch.zeros_like(ok)
        newly = ok & ~conv
        xout = torch.where(newly, vn, xout)
        uout = torch.where(newly, zn, uout)
        iters = torch.where(newly, i + 1, iters)
        solved = torch.where(newly, 1, solved)
        conv = conv | newly
        v, z = vn, zn
        if bool(conv.all()):
            break
        # linear cost and backward recursion
        r = rref - rho * (zn - y)
        q = qref - rho * (vn if state_free else vn - g)
        p = pNref - rho * (vn[-1] if state_free else vn[-1] - g[-1])
        ds_new = [None] * (N - 1)
        for k in range(N - 2, -1, -1):
            ds_new[k] = Quu_inv @ (BT @ p + r[k])
            p = q[k] + AmBKt @ p - KT @ r[k]
        d = torch.stack(ds_new)

    # lanes that never passed report their last slacks
    xout = torch.where(conv, xout, v)
    uout = torch.where(conv, uout, z)
    return (xout.permute(2, 0, 1).contiguous(),
            uout.permute(2, 0, 1).contiguous(), iters, solved)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
# A, B, f, Qd, Rd, rho (pointer, value), Kinf, Quu, AmBKt, Pinf, the bounds,
# the references, x0, the four outputs, the far layout's workspace and
# per-stage terms, then the sizes, settings and layout
_ARGTYPES = ([_PTR] * 6 + [_FLT] + [_PTR] * 17 + [_INT] * 6 + [_FLT] * 2
             + [_INT] * 11 + [_PTR])
_OCC_ARGTYPES = [_INT] * 8 + [ctypes.POINTER(_INT)] * 3


@functools.cache
def _library():
    lib = load_library("fused_stage").lib
    lib.tinympc_fused_stage.argtypes = _ARGTYPES
    lib.tinympc_fused_stage.restype = ctypes.c_int
    lib.tinympc_fused_stage_occupancy.argtypes = _OCC_ARGTYPES
    lib.tinympc_fused_stage_occupancy.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda_inputs(tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("the fused per-stage kernel takes CUDA tensors "
                             "only")
        if t.dtype != torch.float32:
            raise TypeError(f"the fused per-stage kernel is float32; got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the fused per-stage kernel takes contiguous "
                             f"tensors; got strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")


def variant_label(mangled: str) -> str | None:
    """``nx x nu, G, registers|shared, free|box[, far]`` of a K3 instance
    from its mangled name (``fused_stage_kernel<nx, nu, G, regs,
    state_free, far>``; nx 0 is the generic variant), ``wide, G,
    free|box`` of the wide variant's (``fused_stage_wide_kernel<G,
    state_free>``), None for another symbol."""
    m = re.search(r"fused_stage_(wide_)?kernelI((?:L[ib]\d+E)+)E", mangled)
    if m is None:
        return None
    vals = [int(v) for v in re.findall(r"L[ib](\d+)E", m.group(2))]
    if m.group(1):
        g, free = vals
        return f"wide, G={g}, {'free' if free else 'box'}"
    nx, nu, g, regs, free, far = vals
    shape = f"{nx}x{nu}" if nx else "generic"
    return (f"{shape}, G={g}, {'registers' if regs else 'shared'}, "
            f"{'free' if free else 'box'}{', far' if far else ''}")


def stage_occupancy(plan: StagePlan, nx: int, nu: int,
                    en_state_bound: bool) -> dict:
    """What the CUDA runtime says of the variant ``plan`` launches: resident
    blocks and warps an SM, registers a thread, local (spill) bytes a
    thread."""
    blocks, regs, local = _INT(), _INT(), _INT()
    err = _library().tinympc_fused_stage_occupancy(
        nx, nu, plan.group, int(plan.registers), int(en_state_bound),
        int(plan.workspace_global), plan.tile, plan.smem,
        ctypes.byref(blocks), ctypes.byref(regs), ctypes.byref(local))
    if err != 0:
        raise RuntimeError(f"fused_stage occupancy query failed: CUDA error "
                           f"{err}")
    return dict(blocks_per_sm=blocks.value,
                warps_per_sm=blocks.value * plan.threads // 32,
                registers=regs.value, local_bytes=local.value)


@functools.cache
def _occupancy(plan: StagePlan, nx, nu, en_state_bound, device) -> int:
    """Blocks of ``plan``'s variant an SM holds at once."""
    with torch.cuda.device(device):
        return stage_occupancy(plan, nx, nu, en_state_bound)["blocks_per_sm"]


def launch_plan(nx: int, nu: int, N: int, en_state_bound: bool, batch: int,
                device, far: bool = False) -> StagePlan:
    """The plan a launch on ``device`` takes: ``fused_stage_plan`` with the
    far layout's ring weighed by the occupancy API."""
    device = torch.device(device)
    return fused_stage_plan(
        nx, nu, N, en_state_bound, batch, _sm_count(device), far=far,
        resident=lambda plan: _occupancy(plan, nx, nu, en_state_bound,
                                         device))


def fused_cuda(A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min,
               x_max, u_min, u_max, Xref, Uref, x0s, *, nx, nu, N, max_iter,
               abs_pri_tol, abs_dua_tol, en_state_bound, en_input_bound,
               check_termination):
    """Launch kernel K3 (csrc/fused_stage.cu) on CUDA tensors; the arguments
    and results are those of ``fused_reference``.  One launch: the kernel
    reads the caller's tensors and ``rho`` (a float, or a 0-d tensor read on
    the card) itself.  Raises on CPU tensors, on any dtype but float32, on a
    non-contiguous tensor, and when the build or the launch fails.  Counts
    every launch in ``.launches``.

    The far layout (``StagePlan.workspace_global``) takes a global
    workspace of ``N`` records (``record_floats``) for each lane slot of
    the grid (as many blocks as the SMs hold, from the occupancy query)
    and, with ``stage_global``, the per-stage terms computed here in the
    kernel's layout (the same float32 products as its prologue)."""
    args = (A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min, x_max,
            u_min, u_max, Xref, Uref, x0s)
    _check_cuda_inputs(_validate(args, nx, nu, N))
    if check_termination < 1:
        raise ValueError(f"check_termination must be >= 1 (got "
                         f"{check_termination})")
    Bsz = x0s.shape[0]
    if Bsz == 0:
        raise ValueError("empty batch")
    dev = x0s.device
    plan = launch_plan(nx, nu, N, en_state_bound, Bsz, dev)
    xs = torch.empty((Bsz, N, nx), dtype=torch.float32, device=dev)
    us = torch.empty((Bsz, N - 1, nu), dtype=torch.float32, device=dev)
    iters = torch.empty((Bsz,), dtype=torch.int32, device=dev)
    solved = torch.empty((Bsz,), dtype=torch.int32, device=dev)
    if isinstance(rho, torch.Tensor):  # read on the card: no host sync
        rho_ptr, rho_val = rho.data_ptr(), 0.0
    else:
        rho_ptr, rho_val = None, float(rho)
    wsg = stg = None
    slots = 0
    if plan.workspace_global:  # a column for each lane slot of the grid
        occ = _occupancy(plan, nx, nu, en_state_bound, dev)
        tiles = min(-(-Bsz // plan.tile),
                    max(occ, 1) * _sm_count(dev))
        slots = tiles * plan.tile
        wsg = torch.empty((slots, N, record_floats(nx, nu, en_state_bound)),
                          dtype=torch.float32, device=dev)
    if plan.stage_global:
        terms = [-(Xref * Qd), -(Uref * Rd), u_min, u_max]
        if en_state_bound:
            terms += [x_min, x_max]
        stg = torch.cat([t.reshape(-1) for t in terms])
    head = [t.data_ptr() for t in (A, B, f, Qd, Rd)]
    tail = [t.data_ptr() for t in (Kinf, Quu_inv, AmBKt, Pinf, x_min, x_max,
                                   u_min, u_max, Xref, Uref, x0s, xs, us,
                                   iters, solved)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().tinympc_fused_stage(
            *head, rho_ptr, rho_val, *tail,
            None if wsg is None else wsg.data_ptr(),
            None if stg is None else stg.data_ptr(), nx, nu, N, Bsz,
            max_iter, check_termination, abs_pri_tol, abs_dua_tol,
            int(en_input_bound), int(en_state_bound), plan.group,
            int(plan.registers), plan.tile, plan.smem,
            int(plan.workspace_global), slots, plan.ring,
            int(plan.stage_global), int(plan.matrices_global), stream)
    if err != 0:
        raise RuntimeError(f"fused_stage kernel launch failed: CUDA error "
                           f"{err}")
    fused_cuda.launches += 1
    return xs, us, iters, solved


fused_cuda.launches = 0


def make_fused_solver(nx: int, nu: int, N: int, *, max_iter: int = 100,
                      abs_pri_tol: float = 1e-3, abs_dua_tol: float = 1e-3,
                      en_state_bound: bool = False,
                      en_input_bound: bool = True,
                      check_termination: int = 1):
    """Build ``solve_fn(A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf,
    x_min, x_max, u_min, u_max, Xref, Uref, x0s) -> (x (B, N, nx), u (B, N-1,
    nu), iters (B,), solved (B,))``.

    ``x0s`` is (B, nx), any B; the bounds are (N, nx)/(N-1, nu) and the
    references (N, nx)/(N-1, nu), shared by the batch; ``Qd``/``Rd`` are the
    rho-folded cost diagonals; ``rho`` is a float or a 0-d tensor.  The
    solutions are the slack iterates, as in the reference.
    ``check_termination=k`` lets a lane latch only on every k-th
    iteration."""
    if check_termination < 1:
        raise ValueError(f"check_termination must be >= 1 (got "
                         f"{check_termination})")
    kw = dict(nx=nx, nu=nu, N=N, max_iter=max_iter, abs_pri_tol=abs_pri_tol,
              abs_dua_tol=abs_dua_tol, en_state_bound=en_state_bound,
              en_input_bound=en_input_bound,
              check_termination=check_termination)

    def solve_fn(A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min,
                 x_max, u_min, u_max, Xref, Uref, x0s):
        if x0s.device.type == "cuda":
            fn = fused_cuda
        elif x0s.device.type == "cpu":
            fn = fused_reference
        else:
            raise ValueError(f"no fused solver for device {x0s.device}")
        return fn(A, B, f, Qd, Rd, rho, Kinf, Quu_inv, AmBKt, Pinf, x_min,
                  x_max, u_min, u_max, Xref, Uref, x0s, **kw)

    return solve_fn
