"""Core data types of the PyTorch port (counterpart of tinympc_julia_tpu/types.py).

The JAX package keeps its solver state in immutable flax pytrees; here they are
plain dataclasses holding tensors.  Every tensor of a ``Problem`` or ``Cache``
lives on the device and in the dtype its constructor was given: nothing in the
port picks a device by itself.

Layout matches the JAX package: horizon-major ``(N, nx)`` / ``(N-1, nu)``
arrays, so the tests can compare the two field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _as(v, dtype, device) -> torch.Tensor:
    """A contiguous copy on ``device`` in ``dtype`` of a tensor, numpy array
    or scalar (the Problem never aliases its caller's arrays)."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v))
    return v.to(device=device, dtype=dtype).clone(
        memory_format=torch.contiguous_format)


@dataclasses.dataclass(frozen=True)
class ConeSet:
    """Second-order cone constraints on a stage vector: cone k is the scaled
    SOC ``||w[:-1]|| <= mus[k] * w[-1]`` on ``w = vec[starts[k]:starts[k] +
    dims[k]]`` (JAX ConeSet).  ``starts``/``dims`` are plain ints, ``mus`` a
    tensor on the problem's device."""
    mus: torch.Tensor
    starts: Tuple[int, ...] = ()
    dims: Tuple[int, ...] = ()

    @property
    def num_cones(self) -> int:
        return len(self.starts)

    @staticmethod
    def empty(dtype, device) -> "ConeSet":
        return ConeSet(mus=torch.zeros((0,), dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class Problem:
    """Problem data.  ``Q``/``R`` are the rho-folded cost diagonals
    (user cost + rho), as in the JAX package."""
    A: torch.Tensor       # (nx, nx)
    B: torch.Tensor       # (nx, nu)
    f: torch.Tensor       # (nx,)
    Q: torch.Tensor       # (nx,)
    R: torch.Tensor       # (nu,)
    x_min: torch.Tensor   # (N, nx)
    x_max: torch.Tensor   # (N, nx)
    u_min: torch.Tensor   # (N-1, nu)
    u_max: torch.Tensor   # (N-1, nu)
    Xref: torch.Tensor    # (N, nx)
    Uref: torch.Tensor    # (N-1, nu)
    Alin_x: torch.Tensor  # (mx, nx)
    blin_x: torch.Tensor  # (mx,)
    Alin_u: torch.Tensor  # (mu, nu)
    blin_u: torch.Tensor  # (mu,)
    cones_x: ConeSet
    cones_u: ConeSet
    rho_setup: torch.Tensor  # scalar: the rho folded into Q/R

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]

    @property
    def N(self) -> int:
        return self.Xref.shape[-2]

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @property
    def device(self) -> torch.device:
        return self.A.device

    def replace(self, **kw) -> "Problem":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings; field names and defaults as in the JAX Settings.

    Both packages share one settings surface; a solve path that does not
    take a field (``bf16_head_iters`` with adaptive rho, say) raises."""
    abs_pri_tol: float = 1e-3
    abs_dua_tol: float = 1e-3
    adaptive_rho_min: float = 1.0
    adaptive_rho_max: float = 100.0
    adaptive_rho_taylor_trust: float = float("inf")
    relaxation_alpha: float = 1.0
    max_iter: int = 1000
    check_termination: int = 1
    en_state_bound: bool = True
    en_input_bound: bool = True
    en_state_soc: bool = False
    en_input_soc: bool = False
    en_state_linear: bool = False
    en_input_linear: bool = False
    adaptive_rho: bool = False
    adaptive_rho_enable_clipping: bool = True
    adaptive_rho_rebuild: bool = False
    adaptive_rho_controller: str = "osqp"
    bf16_head_iters: int = 0

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def settings_bake_key(s: Settings) -> tuple:
    """Hashable key of every setting (the JAX package keys its compiled
    kernels on it; the port's kernel takes all of them at run time)."""
    return dataclasses.astuple(s)


def default_settings() -> Settings:
    """Library defaults (the JAX package's default_settings)."""
    return Settings()


@dataclasses.dataclass(frozen=True)
class Cache:
    """Riccati cache and its exact d/drho sensitivities (JAX Cache)."""
    rho: torch.Tensor
    Kinf: torch.Tensor     # (nu, nx)
    Pinf: torch.Tensor     # (nx, nx)
    Quu_inv: torch.Tensor  # (nu, nu)
    AmBKt: torch.Tensor    # (nx, nx)
    C1: torch.Tensor       # (nu, nu) == Quu_inv at setup
    C2: torch.Tensor       # (nx, nx) == AmBKt at setup
    dKinf_drho: torch.Tensor
    dPinf_drho: torch.Tensor
    dC1_drho: torch.Tensor
    dC2_drho: torch.Tensor

    def replace(self, **kw) -> "Cache":
        return dataclasses.replace(self, **kw)


def map_tensors(fn, *trees):
    """A dataclass like ``trees[0]`` (a Problem, Cache, State or Solution)
    whose every tensor field is ``fn`` of the trees' fields.  A cone set maps
    its ``mus``; its structure (``starts``, ``dims``) is static and must be
    the same in every tree."""
    first = trees[0]
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(t, f.name) for t in trees]
        if isinstance(vals[0], ConeSet):
            for c in vals[1:]:
                if c.starts != vals[0].starts or c.dims != vals[0].dims:
                    raise ValueError(
                        "the cone structure (starts, dims) must be the same "
                        f"in every item; got {vals[0].starts}/{vals[0].dims} "
                        f"and {c.starts}/{c.dims}")
            out[f.name] = ConeSet(mus=fn(*(c.mus for c in vals)),
                                  starts=vals[0].starts, dims=vals[0].dims)
        else:
            out[f.name] = fn(*vals)
    return type(first)(**out)


def stack_instances(items):
    """Stack identically shaped Problems (or Caches, States, Solutions) into
    one with a leading group axis on every tensor; the cone coefficients
    stack to (G, C)."""
    items = list(items)
    if not items:
        raise ValueError("stack_instances needs at least one item")
    return map_tensors(lambda *ts: torch.stack(ts), *items)


def index_instance(tree, b: int):
    """Item ``b`` of a stacked Problem, Cache, State or Solution."""
    return map_tensors(lambda t: t[b], tree)


def expand_lanes(tree, L: int):
    """A (G, ...) Problem or Cache -> its (G*L, ...) per-lane copy, lane =
    g*L + l."""
    return map_tensors(lambda t: t.repeat_interleave(L, dim=0), tree)


def make_problem(A, B, Q, R, rho, N, *, device, f=None, x_min=None,
                 x_max=None, u_min=None, u_max=None, Xref=None, Uref=None,
                 Alin_x=None, blin_x=None, Alin_u=None, blin_u=None,
                 cones_x=None, cones_u=None, dtype=None) -> Problem:
    """Build a Problem with the rho folded once into the cost diagonals
    (``Q + rho``, ``R + rho``).  ``Q``/``R`` may be matrices (their
    diagonals are taken) or diagonal vectors.  Bounds that are not given
    are filled with -inf/+inf.  ``dtype=None`` keeps ``A``'s dtype."""
    if dtype is None:
        dtype = (A.dtype if isinstance(A, torch.Tensor)
                 else torch.from_numpy(np.asarray(A)).dtype)
    A = _as(A, dtype, device)
    B = _as(B, dtype, device)
    nx, nu = A.shape[0], B.shape[1]
    Q = _as(Q, dtype, device)
    R = _as(R, dtype, device)
    if Q.ndim == 2:
        Q = torch.diagonal(Q)
    if R.ndim == 2:
        R = torch.diagonal(R)
    rho = _as(rho, dtype, device)
    Q = Q + rho
    R = R + rho

    def as_or(v, shape, default):
        if v is None:
            return torch.full(shape, default, dtype=dtype, device=device)
        return _as(v, dtype, device).broadcast_to(shape).contiguous()

    def rows(v, cols):
        if v is None:
            return torch.zeros((0,) + cols, dtype=dtype, device=device)
        return _as(v, dtype, device)

    inf = float("inf")
    return Problem(
        A=A, B=B, f=as_or(f, (nx,), 0.0), Q=Q, R=R,
        x_min=as_or(x_min, (N, nx), -inf), x_max=as_or(x_max, (N, nx), inf),
        u_min=as_or(u_min, (N - 1, nu), -inf),
        u_max=as_or(u_max, (N - 1, nu), inf),
        Xref=as_or(Xref, (N, nx), 0.0), Uref=as_or(Uref, (N - 1, nu), 0.0),
        Alin_x=rows(Alin_x, (nx,)), blin_x=rows(blin_x, ()),
        Alin_u=rows(Alin_u, (nu,)), blin_u=rows(blin_u, ()),
        cones_x=cones_x if cones_x is not None else ConeSet.empty(dtype, device),
        cones_u=cones_u if cones_u is not None else ConeSet.empty(dtype, device),
        rho_setup=rho,
    )


@dataclasses.dataclass(frozen=True)
class State:
    """The solver workspace of the single-instance solve (JAX State):
    horizon-major iterates, the four residuals of the last check, the status
    (11 unsolved, 1 solved) and the iteration count.  Persisting it across
    ``solve`` calls is the reference's warm start."""
    x: torch.Tensor     # (N, nx)   state trajectory
    u: torch.Tensor     # (N-1, nu) input trajectory
    q: torch.Tensor     # (N, nx)   linear state cost
    r: torch.Tensor     # (N-1, nu) linear input cost
    p: torch.Tensor     # (N, nx)   Riccati linear terms
    d: torch.Tensor     # (N-1, nu) feedforward terms
    v: torch.Tensor     # (N, nx)   previous state slack
    vnew: torch.Tensor  # (N, nx)
    z: torch.Tensor     # (N-1, nu) previous input slack
    znew: torch.Tensor  # (N-1, nu)
    g: torch.Tensor     # (N, nx)   state dual
    y: torch.Tensor     # (N-1, nu) input dual
    primal_residual_state: torch.Tensor  # 0-d
    primal_residual_input: torch.Tensor
    dual_residual_state: torch.Tensor
    dual_residual_input: torch.Tensor
    status: torch.Tensor  # 0-d int32
    iter: torch.Tensor    # 0-d int32

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Solution:
    """JAX Solution: ``x``/``u`` are the slack iterates vnew/znew, as the
    reference returns them."""
    iter: torch.Tensor    # 0-d int32
    solved: torch.Tensor  # 0-d int32
    x: torch.Tensor       # (N, nx)
    u: torch.Tensor       # (N-1, nu)


def init_state(nx: int, nu: int, N: int, *, device,
               dtype=torch.float64) -> State:
    """Zero workspace (JAX init_state)."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = dict(dtype=torch.int32, device=device)
    return State(
        x=zeros(N, nx), u=zeros(N - 1, nu), q=zeros(N, nx),
        r=zeros(N - 1, nu), p=zeros(N, nx), d=zeros(N - 1, nu),
        v=zeros(N, nx), vnew=zeros(N, nx), z=zeros(N - 1, nu),
        znew=zeros(N - 1, nu), g=zeros(N, nx), y=zeros(N - 1, nu),
        primal_residual_state=zeros(), primal_residual_input=zeros(),
        dual_residual_state=zeros(), dual_residual_input=zeros(),
        status=torch.zeros((), **i32), iter=torch.zeros((), **i32))
