"""User-facing solver (counterpart of tinympc_julia_tpu/api.py).

``TinyMPCSolver`` holds a Problem, its Riccati Cache, Settings and the
single-instance workspace on one device, chosen by the caller.  Ported so
far: setup, the x0/reference setters, the bound, linear, cone and equality
constraints, settings and cache injection, the single-instance ``solve``
(ops/admm.py) with its persisted warm start and adaptive rho, the
long-horizon recursions (chunked, or associative scans with
``horizon_parallel``; ops/scans.py), ``solve_batch`` on the standard
(parallel/batch.py), chunked, condensed and fused paths (kernel K1 with its
projections and its reduced-precision head; with ``adaptive_rho`` the
Taylor-expanded maps and kernel K2) with warm continuation, and
``solve_batch_rebuild_adaptive`` (the bucketed exact-rebuild pipeline,
parallel/rebuild.py), the rho sensitivities of the Julia-style LQR
(``compute_sensitivity_autograd``), ``print_problem_data``, the embedded C++
emitter (``codegen``, ``codegen_with_sensitivity``; codegen/emitter.py) and
checkpoints in the JAX package's file format (``save``, ``load``;
utils/checkpoint.py).

Matrix layout at this boundary follows the reference: states (nx, N),
controls (nu, N-1); ``solve_batch`` returns tensors on the solver's device,
(B, N, nx) and (B, N-1, nu).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import types as T
from .codegen import emitter
from .ops import admm, riccati
from .ops.condensed import (auto_chunk_size, auto_uses_condensed,
                            build_condensed, build_condensed_taylor,
                            solve_condensed, solve_condensed_adaptive)
from .ops.cuda.adaptive_kernel import make_condensed_adaptive_fused_solver
from .ops.cuda.condensed_kernel import (make_condensed_fused_solver,
                                        problem_constraint_kw)
from .ops.rho import RHO_INTERVAL
from .ops.scans import build_chunk_maps
from .parallel import batch as batch_mod
from .parallel.rebuild import (bucket_maps, default_bucket_rhos,
                               make_bucketed_rebuild)
from .utils import checkpoint


class MPCSolution(NamedTuple):
    states: np.ndarray    # (nx, N)
    controls: np.ndarray  # (nu, N-1)


@dataclasses.dataclass
class BatchWarmCarry:
    """Opaque warm-start carry of ``solve_batch(return_carry=True)``,
    accepted back as ``warm=``: two chained calls equal one long solve lane
    for lane (with adaptive rho: the continuation restarts the rho-update
    counter, as the JAX package's does).  On the fused path it holds the
    kernel's FusedCarry, with adaptive rho its AdaptiveFusedCarry."""
    method: str
    batch: int
    data: object


class TinyMPCSolver:
    """Stateful wrapper over the functional core, on an explicit device.

        solver = TinyMPCSolver(dtype=torch.float32, device="cuda")
        solver.setup(A, B, f, Q, R, rho, nx, nu, N)
        solver.set_bound_constraints(x_min, x_max, u_min, u_max)
        solver.set_x0(x0); solver.solve(); solver.get_solution()
        xs, us, iters, solved = solver.solve_batch(x0s, method="fused")
    """

    def __init__(self, dtype=torch.float64, *, device):
        self.dtype = dtype or torch.float64
        self.device = torch.device(device)
        self.problem: Optional[T.Problem] = None
        self.cache: Optional[T.Cache] = None
        self.settings: T.Settings = T.default_settings()
        self.state: Optional[T.State] = None
        self.solution: Optional[T.Solution] = None
        self.is_setup = False
        # the associative-scan horizon recursions in solve() (ops/scans.py)
        self.horizon_parallel = False
        # the user's data as setup took it, for the sensitivities and the
        # checkpoint's metadata
        self._user = {}
        self._drop_maps()
        # per-bucket straggler-slot overflow of the last bucketed-rebuild
        # solve (None before any)
        self.last_overflow = None

    # -- setup --------------------------------------------------------------

    def setup(self, A, B, f, Q, R, rho, nx=None, nu=None, N=None, *,
              verbose=False, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
              max_iter=100, check_termination=True, adaptive_rho=False,
              adaptive_rho_min=0.1, adaptive_rho_max=10.0,
              adaptive_rho_clipping=True):
        """Problem construction and Riccati cache precompute; all constraint
        flags start disabled and the setters enable them, as in the JAX
        package."""
        A = np.asarray(A, float)
        B = np.asarray(B, float)
        nx = nx or A.shape[0]
        nu = nu or B.shape[1]
        if N is None:
            raise ValueError("horizon length N is required")
        if A.shape != (nx, nx):
            raise ValueError(f"A has shape {A.shape}, expected ({nx}, {nx})")
        if B.shape != (nx, nu):
            raise ValueError(f"B has shape {B.shape}, expected ({nx}, {nu})")
        Qm = np.asarray(Q, float)
        Rm = np.asarray(R, float)
        if Qm.shape not in ((nx, nx), (nx,)):
            raise ValueError(f"Q has shape {Qm.shape}, expected ({nx}, {nx})")
        if Rm.shape not in ((nu, nu), (nu,)):
            raise ValueError(f"R has shape {Rm.shape}, expected ({nu}, {nu})")
        f = np.zeros(nx) if f is None else np.asarray(f, float).reshape(nx)

        self._user = dict(A=A, B=B, Q=Qm if Qm.ndim == 2 else np.diag(Qm),
                          R=Rm if Rm.ndim == 2 else np.diag(Rm),
                          f=f, rho=float(rho), nx=nx, nu=nu, N=N)
        self.problem = T.make_problem(A, B, Qm, Rm, rho, N, f=f,
                                      dtype=self.dtype, device=self.device)
        p = self.problem
        self.cache = riccati.precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
        self.settings = T.Settings(
            abs_pri_tol=float(abs_pri_tol), abs_dua_tol=float(abs_dua_tol),
            max_iter=int(max_iter), check_termination=int(check_termination),
            en_state_bound=False, en_input_bound=False,
            adaptive_rho=bool(adaptive_rho),
            adaptive_rho_min=float(adaptive_rho_min),
            adaptive_rho_max=float(adaptive_rho_max),
            adaptive_rho_enable_clipping=bool(adaptive_rho_clipping))
        self.state = T.init_state(nx, nu, N, dtype=self.dtype,
                                  device=self.device)
        self.solution = None
        self._drop_maps()
        self.is_setup = True
        if verbose:
            print(f"TinyMPC solver setup successful (nx={nx}, nu={nu}, N={N})")
        return 0

    def _drop_maps(self):
        """Forget the condensed maps (fixed, Taylor-expanded, the rebuild
        pipeline's bucket maps keyed on their rhos) and the chunk maps: they
        bake the references and the cache terms."""
        self._condensed_maps = None
        self._condensed_taylor_maps = None
        self._bucket_maps = {}
        self._chunk_maps = None

    def _require_setup(self):
        if not self.is_setup:
            raise RuntimeError("Solver not setup")

    def _tensor(self, a):
        return torch.as_tensor(np.array(a, float, order="C"),
                               dtype=self.dtype, device=self.device)

    # -- state / reference setters -----------------------------------------

    def set_x0(self, x0, *, verbose=False):
        """Initial state of the single-instance ``solve``: the workspace's
        x[0]."""
        self._require_setup()
        x0 = self._tensor(np.asarray(x0, float).reshape(-1))
        if x0.shape[0] != self.problem.nx:
            raise ValueError("x0 is not the correct length")
        x = self.state.x.clone()
        x[0] = x0
        self.state = self.state.replace(x=x)
        return 0

    def set_x_ref(self, x_ref, *, verbose=False):
        """State reference in the reference layout (nx, N)."""
        self._require_setup()
        x_ref = np.asarray(x_ref, float)
        nx, N = self.problem.nx, self.problem.N
        if x_ref.shape != (nx, N):
            raise ValueError(f"x_ref has shape {x_ref.shape}, expected "
                             f"({nx}, {N})")
        self.problem = self.problem.replace(Xref=self._tensor(x_ref.T))
        self._drop_maps()
        return 0

    def set_u_ref(self, u_ref, *, verbose=False):
        """Input reference in the reference layout (nu, N-1)."""
        self._require_setup()
        u_ref = np.asarray(u_ref, float)
        nu, N = self.problem.nu, self.problem.N
        if u_ref.shape != (nu, N - 1):
            raise ValueError(f"u_ref has shape {u_ref.shape}, expected "
                             f"({nu}, {N - 1})")
        self.problem = self.problem.replace(Uref=self._tensor(u_ref.T))
        self._drop_maps()
        return 0

    # -- constraints --------------------------------------------------------

    def set_bound_constraints(self, x_min, x_max, u_min, u_max, *,
                              verbose=False):
        """Box bounds in the reference layout (nx, N) / (nu, N-1); enables
        both bound flags."""
        self._require_setup()
        nx, nu, N = self.problem.nx, self.problem.nu, self.problem.N

        def box(a, shape):
            return self._tensor(np.broadcast_to(np.asarray(a, float),
                                                shape).T)

        self.problem = self.problem.replace(
            x_min=box(x_min, (nx, N)), x_max=box(x_max, (nx, N)),
            u_min=box(u_min, (nu, N - 1)), u_max=box(u_max, (nu, N - 1)))
        self.settings = self.settings.replace(en_state_bound=True,
                                              en_input_bound=True)
        return 0

    def set_linear_constraints(self, Alin_x, blin_x, Alin_u, blin_u, *,
                               verbose=False):
        """Per-stage halfspaces Alin_x x <= blin_x, Alin_u u <= blin_u;
        enables each family's flag when it has rows."""
        self._require_setup()
        p = self.problem
        Alin_x = np.asarray(Alin_x, float).reshape(-1, p.nx)
        Alin_u = np.asarray(Alin_u, float).reshape(-1, p.nu)
        blin_x = np.asarray(blin_x, float).reshape(-1)
        blin_u = np.asarray(blin_u, float).reshape(-1)
        if blin_x.shape[0] != Alin_x.shape[0] or \
                blin_u.shape[0] != Alin_u.shape[0]:
            raise ValueError("each halfspace row needs one bound")
        self.problem = p.replace(
            Alin_x=self._tensor(Alin_x), blin_x=self._tensor(blin_x),
            Alin_u=self._tensor(Alin_u), blin_u=self._tensor(blin_u))
        s = self.settings
        self.settings = s.replace(
            en_state_linear=s.en_state_linear or Alin_x.shape[0] > 0,
            en_input_linear=s.en_input_linear or Alin_u.shape[0] > 0)
        return 0

    def set_cone_constraints(self, Acu, qcu, cu, Acx, qcx, cx, *,
                             verbose=False):
        """Scaled SOC constraints ||w[start:start+q-1]|| <= mu *
        w[start+q-1]: start indices, cone dims and coefficients, inputs
        first, then states; enables each family's flag when it has cones."""
        self._require_setup()

        def cones(starts, dims, mus, n):
            c = T.ConeSet(mus=self._tensor(np.asarray(mus, float)
                                           .reshape(-1)),
                          starts=tuple(int(i) for i in np.asarray(starts)
                                       .reshape(-1)),
                          dims=tuple(int(i) for i in np.asarray(dims)
                                     .reshape(-1)))
            if not len(c.starts) == len(c.dims) == c.mus.shape[0]:
                raise ValueError("each cone needs a start, a dim and a mu")
            for st, dm in zip(c.starts, c.dims):
                if st < 0 or dm < 2 or st + dm > n:
                    raise ValueError(f"cone [{st}, {st + dm}) does not fit "
                                     f"a stage vector of {n}")
            return c

        cones_u = cones(Acu, qcu, cu, self.problem.nu)
        cones_x = cones(Acx, qcx, cx, self.problem.nx)
        self.problem = self.problem.replace(cones_u=cones_u, cones_x=cones_x)
        s = self.settings
        self.settings = s.replace(
            en_input_soc=s.en_input_soc or cones_u.num_cones > 0,
            en_state_soc=s.en_state_soc or cones_x.num_cones > 0)
        return 0

    def set_equality_constraints(self, Aeq_x, beq_x, Aeq_u=None, beq_u=None):
        """Equalities lowered to inequality pairs (A w <= b, -A w <= -b), as
        the Julia layer does."""
        self._require_setup()
        nx, nu = self.problem.nx, self.problem.nu
        Aeq_x = np.asarray(Aeq_x, float).reshape(-1, nx)
        beq_x = np.asarray(beq_x, float).reshape(-1)
        Aeq_u = np.zeros((0, nu)) if Aeq_u is None else \
            np.asarray(Aeq_u, float).reshape(-1, nu)
        beq_u = np.zeros(0) if beq_u is None else \
            np.asarray(beq_u, float).reshape(-1)
        return self.set_linear_constraints(
            np.vstack([Aeq_x, -Aeq_x]), np.concatenate([beq_x, -beq_x]),
            np.vstack([Aeq_u, -Aeq_u]), np.concatenate([beq_u, -beq_u]))

    # -- settings / cache ----------------------------------------------------

    def update_settings(self, **kwargs):
        """Update settings by their Julia keyword names (bools or ints for
        flags); the same names as the JAX package."""
        self._require_setup()
        mapping = dict(
            abs_pri_tol=float, abs_dua_tol=float, max_iter=int,
            check_termination=int, en_state_bound=bool, en_input_bound=bool,
            en_state_soc=bool, en_input_soc=bool, en_state_linear=bool,
            en_input_linear=bool, adaptive_rho=bool, adaptive_rho_min=float,
            adaptive_rho_max=float, adaptive_rho_enable_clipping=bool,
            relaxation_alpha=float, adaptive_rho_rebuild=bool,
            adaptive_rho_controller=str, adaptive_rho_taylor_trust=float,
            bf16_head_iters=int)
        kwargs.pop("verbose", None)
        if "adaptive_rho_clipping" in kwargs:
            kwargs["adaptive_rho_enable_clipping"] = kwargs.pop(
                "adaptive_rho_clipping")
        updates = {}
        for key, value in kwargs.items():
            if key not in mapping:
                raise TypeError(f"unknown setting: {key}")
            updates[key] = mapping[key](value)
        self.settings = self.settings.replace(**updates)
        return 0

    def set_cache_terms(self, Kinf, Pinf, Quu_inv, AmBKt, *, verbose=False):
        """Inject externally computed cache terms, bypassing the Riccati
        precompute."""
        self._require_setup()
        self.cache = self.cache.replace(
            Kinf=self._tensor(Kinf), Pinf=self._tensor(Pinf),
            Quu_inv=self._tensor(Quu_inv), AmBKt=self._tensor(AmBKt))
        self._drop_maps()
        return 0

    # -- solve ---------------------------------------------------------------

    def solve(self, *, verbose=False, chunked=None):
        """Run ADMM to convergence from the persisted workspace (the
        reference's warm start) and persist the new workspace and cache.
        Returns 0 on convergence, 1 when max_iter runs out.

        ``chunked=None`` picks the chunked horizon recursions
        (ops/scans.py) for long horizons, where the condensed maps would
        outgrow their memory budget and a chunk size fits (not with
        ``horizon_parallel`` or adaptive rho); they give the same iterates
        up to float reassociation.  ``False`` forces the exact sequential
        recursions, ``True`` the chunked ones (raising where no chunk size
        fits, or with adaptive rho).  ``self.horizon_parallel = True`` runs
        the recursions as associative scans."""
        self._require_setup()
        p = self.problem
        cm = None
        if chunked is None:
            chunked = (not self.horizon_parallel
                       and not self.settings.adaptive_rho
                       and not auto_uses_condensed(p.nx, p.nu, p.N)
                       and auto_chunk_size(p.nx, p.nu, p.N) is not None)
        if chunked:  # admm.solve refuses chunk maps under adaptive rho
            cm = self._get_chunk_maps()
        self.state, self.cache, self.solution = admm.solve(
            p, self.cache, self.settings, self.state,
            horizon_parallel=self.horizon_parallel, chunk_maps=cm)
        status = 1 - int(self.solution.solved)
        if verbose:
            print(f"Solve completed with status: {status}")
        return status

    def get_solution(self) -> MPCSolution:
        """(states (nx, N), controls (nu, N-1)) of the last ``solve``."""
        self._require_setup()
        if self.solution is None:
            raise RuntimeError("No solution available; call solve() first")
        return MPCSolution(states=self.solution.x.cpu().numpy().T,
                           controls=self.solution.u.cpu().numpy().T)

    def _maps(self):
        if self._condensed_maps is None:
            self._condensed_maps = build_condensed(self.problem, self.cache)
        return self._condensed_maps

    def _taylor_maps(self):
        if self._condensed_taylor_maps is None:
            self._condensed_taylor_maps = build_condensed_taylor(
                self.problem, self.cache)
        return self._condensed_taylor_maps

    def _get_chunk_maps(self):
        """The chunk maps (ops/scans.build_chunk_maps) at the auto-selected
        chunk size, built once and kept until the problem or cache
        changes."""
        if self._chunk_maps is None:
            p = self.problem
            C = auto_chunk_size(p.nx, p.nu, p.N)
            if C is None:
                raise ValueError(
                    f"no chunk size >= 2 divides N-1 = {p.N - 1} within the "
                    "chunk-map budget; use method='standard'")
            self._chunk_maps = build_chunk_maps(p, self.cache, C)
        return self._chunk_maps

    def solve_batch(self, x0s, *, method: str = "auto", warm=None,
                    return_carry: bool = False, verbose=False):
        """Batched fresh solves over per-instance initial states (B, nx).

        ``method``: "standard" (the masked reference-ordered loop of
        parallel/batch.py), "chunked" (the same loop with the chunked
        horizon recursions of ops/scans.py: the long-horizon path, same
        iterates up to float reassociation, fixed rho only), "condensed"
        (the T1/T2 eager solve), "fused" (kernel K1; float32) or "auto"
        (condensed while the maps fit the memory budget; beyond it chunked
        with fixed rho where a chunk size fits, else standard).  With
        ``adaptive_rho`` every lane adapts its own rho: on the
        Taylor-expanded maps (``solve_condensed_adaptive``, or kernel K2 on
        the fused path), or with a per-instance cache on the standard path.
        Pass ``return_carry=True`` to also get a ``BatchWarmCarry`` and give
        it back as ``warm=`` (same method, same batch) to continue: exactly on
        the condensed and fused paths; on the standard path with the
        reference's persisted-workspace semantics (the loop restarts from
        the carried iterates).

        Returns (xs (B, N, nx), us (B, N-1, nu), iters (B,), solved (B,)) as
        tensors on the solver's device, plus the carry on request."""
        self._require_setup()
        p, s = self.problem, self.settings
        x0s = torch.as_tensor(x0s, dtype=self.dtype, device=self.device)
        B = int(x0s.shape[0])
        if method == "auto":
            if auto_uses_condensed(p.nx, p.nu, p.N, adaptive=s.adaptive_rho):
                method = "condensed"
            elif (not s.adaptive_rho
                    and auto_chunk_size(p.nx, p.nu, p.N) is not None):
                method = "chunked"
            else:
                method = "standard"
        if method not in ("standard", "chunked", "condensed", "fused"):
            raise ValueError(f"unknown method: {method}")
        if warm is not None:
            if not isinstance(warm, BatchWarmCarry):
                raise TypeError("warm must be a BatchWarmCarry from a "
                                "previous solve_batch(return_carry=True)")
            if warm.method != method:
                raise ValueError(f"warm carry is for method={warm.method!r}; "
                                 f"this solve resolved to {method!r}")
            if warm.batch != B:
                raise ValueError(f"warm carry holds {warm.batch} lanes, "
                                 f"x0s has {B}")
        if method in ("standard", "chunked"):
            cm = self._get_chunk_maps() if method == "chunked" else None
            if warm is not None:
                st = batch_mod.set_x0_batch(warm.data, x0s)
            else:
                st = batch_mod.set_x0_batch(batch_mod.broadcast_state(
                    T.init_state(p.nx, p.nu, p.N, dtype=self.dtype,
                                 device=self.device), B), x0s)
            st_out, _, sol = batch_mod.solve_batch(p, self.cache, s, st,
                                                   chunk_maps=cm)
            out = (sol.x, sol.u, sol.iter, sol.solved, st_out)
            if not return_carry:
                return out[:4]
            return out[:4] + (BatchWarmCarry(method=method, batch=B,
                                             data=st_out),)
        if s.adaptive_rho and s.adaptive_rho_rebuild:
            raise ValueError(
                "adaptive_rho_rebuild on the condensed/fused fast paths runs "
                "as the bucketed rebuild pipeline "
                "(solve_batch_rebuild_adaptive), or per update with "
                "method='standard'")
        if method == "fused":
            out = self._solve_batch_fused(x0s, warm, return_carry)
        else:
            solve, maps = ((solve_condensed_adaptive, self._taylor_maps())
                           if s.adaptive_rho
                           else (solve_condensed, self._maps()))
            out = solve(p, self.cache, s, x0s, maps,
                        warm=None if warm is None else warm.data,
                        return_carry=return_carry)
        if return_carry:
            return out[:4] + (BatchWarmCarry(method=method, batch=B,
                                             data=out[4]),)
        return out

    def _solve_batch_fused(self, x0s, warm, return_carry):
        """Kernel K1 (K2 with adaptive rho) on the batch as given: the
        kernels mask their ragged last tile and a lane's result does not
        depend on its tile, so no padding is needed.  The solver is made
        anew for every call from the current problem's constraint data, so a
        constraint setter between two calls always reaches the kernel."""
        p, s = self.problem, self.settings
        ct = s.check_termination
        if ct < 1 or s.max_iter % ct != 0:
            raise ValueError(
                "the fused path needs check_termination >= 1 dividing "
                f"max_iter (got {ct} / {s.max_iter})")
        if s.adaptive_rho:
            if s.bf16_head_iters:
                raise ValueError("bf16_head_iters is fixed-rho only (the rho "
                                 "prediction would read bf16-noise residuals)")
            step = math.lcm(RHO_INTERVAL, ct)
            if s.max_iter % step != 0:
                raise ValueError(
                    "fused adaptive-rho needs max_iter divisible by "
                    f"lcm(check_termination, {RHO_INTERVAL}) = {step} (the "
                    f"rho update interval; got max_iter={s.max_iter})")
        if self.dtype != torch.float32:
            raise TypeError("the fused path is float32: build the solver "
                            "with dtype=torch.float32")
        if s.adaptive_rho:
            fn = make_condensed_adaptive_fused_solver(
                p.A, p.B, p.Q, p.R, self.cache.Pinf, self.cache.dPinf_drho,
                p.N, max_iter=s.max_iter, abs_pri_tol=s.abs_pri_tol,
                abs_dua_tol=s.abs_dua_tol, en_state_bound=s.en_state_bound,
                en_input_bound=s.en_input_bound,
                relaxation_alpha=s.relaxation_alpha,
                adaptive_rho_min=s.adaptive_rho_min,
                adaptive_rho_max=s.adaptive_rho_max,
                adaptive_rho_clipping=s.adaptive_rho_enable_clipping,
                check_termination=ct, controller=s.adaptive_rho_controller,
                taylor_trust=s.adaptive_rho_taylor_trust,
                warm_start=warm is not None, carry_out=return_carry,
                **problem_constraint_kw(p, s))
            args = (self._taylor_maps(), p.u_min, p.u_max, p.x_min, p.x_max,
                    x0s)
            if warm is not None:
                args += (warm.data,)
            out = fn(*args)
            return out[:4] + out[5:]  # the per-lane rho rides in the carry
        if s.bf16_head_iters:
            from .parallel.grouped import _warn_short_highest_tail
            _warn_short_highest_tail(s, s.max_iter - s.bf16_head_iters)
        fn = make_condensed_fused_solver(
            p.nx, p.nu, p.N, max_iter=s.max_iter,
            abs_pri_tol=s.abs_pri_tol, abs_dua_tol=s.abs_dua_tol,
            en_state_bound=s.en_state_bound, en_input_bound=s.en_input_bound,
            relaxation_alpha=s.relaxation_alpha, check_termination=ct,
            warm_start=warm is not None, carry_out=return_carry,
            bf16_head_iters=s.bf16_head_iters,
            **problem_constraint_kw(p, s))
        args = (self._maps(), self.cache.rho, p.u_min, p.u_max,
                p.x_min, p.x_max, x0s)
        if warm is not None:
            args += (warm.data,)
        return fn(*args)

    def solve_batch_rebuild_adaptive(self, x0s, *, bucket_rhos=None,
                                     phase1_iters=50, straggler_slots=None,
                                     phase2_iters=500, verbose=False):
        """Batched solves with exact adaptive rho on the fused path: the
        bucketed rebuild pipeline (parallel/rebuild.py), which rescues a
        setup rho that is off by orders of magnitude at the fused kernels'
        rates.  Float32, as the fused path.

        The solver's Settings give the tolerances, constraint flags and
        ``check_termination``, and [adaptive_rho_min, adaptive_rho_max] the
        bucket span (``bucket_rhos`` overrides the log-spaced default).
        ``straggler_slots`` (a bucket; default B) bounds phase 2: lanes
        beyond it keep their unconverged phase-1 result and are counted per
        bucket in ``self.last_overflow``, with a warning.  The bucket caches
        and maps are kept on the solver, keyed on the bucket rhos, until the
        problem or the cache changes; bounds and constraint data reach the
        kernels at every call.

        Returns (xs (B, N, nx), us (B, N-1, nu), iters (B,), solved (B,),
        rho (B,)) as tensors on the solver's device."""
        self._require_setup()
        if self.dtype != torch.float32:
            raise TypeError("the rebuild pipeline is float32: build the "
                            "solver with dtype=torch.float32")
        s = self.settings
        x0s = torch.as_tensor(x0s, dtype=torch.float32, device=self.device)
        B = int(x0s.shape[0])
        if bucket_rhos is None:
            bucket_rhos = default_bucket_rhos(s.adaptive_rho_min,
                                              s.adaptive_rho_max)
        bucket_rhos = tuple(float(r) for r in bucket_rhos)
        if bucket_rhos not in self._bucket_maps:
            self._bucket_maps[bucket_rhos] = bucket_maps(
                self.problem, self.cache, bucket_rhos)
        pipe = make_bucketed_rebuild(
            self.problem, self.cache, s, bucket_rhos=bucket_rhos,
            phase1_iters=phase1_iters,
            straggler_slots=B if straggler_slots is None
            else int(straggler_slots),
            phase2_iters=phase2_iters, maps=self._maps(),
            bmaps=self._bucket_maps[bucket_rhos])
        xs, us, iters, solved, rho, overflow = pipe.solve(x0s)
        self.last_overflow = overflow
        if verbose or bool(overflow.any()):
            msg = (f"bucketed rebuild: buckets {pipe.bucket_rhos}, overflow "
                   f"{overflow.tolist()}")
            if bool(overflow.any()):
                warnings.warn("straggler_slots too small: " + msg,
                              stacklevel=2)
            else:
                print(msg)
        return xs, us, iters, solved, rho

    # -- sensitivity and diagnostics ----------------------------------------

    def compute_sensitivity_autograd(self):
        """Exact d/drho of the Julia-style LQR terms of the setup data
        (``riccati.compute_sensitivity_autograd``, forward-mode AD).
        Returns (dK, dP, dC1, dC2) as numpy arrays."""
        self._require_setup()
        u = self._user
        out = riccati.compute_sensitivity_autograd(
            *(self._tensor(u[k]) for k in ("A", "B", "Q", "R")), u["rho"])
        return tuple(m.cpu().numpy() for m in out)

    def print_problem_data(self, *, verbose=False):
        """Print the solution's status, rho, the main settings and the
        dimensions (and with ``verbose`` the last solution and Kinf/Pinf),
        in the JAX package's lines."""
        self._require_setup()
        sol = self.solution
        print("=== TinyMPC Problem Data ===")
        print(f"Solution: iter={0 if sol is None else int(sol.iter)}, "
              f"solved={0 if sol is None else int(sol.solved)}")
        print(f"Cache: rho={float(self.cache.rho)}")
        print(f"Settings: max_iter={self.settings.max_iter}, "
              f"abs_pri_tol={self.settings.abs_pri_tol}, "
              f"abs_dua_tol={self.settings.abs_dua_tol}")
        print(f"Problem: nx={self.problem.nx}, nu={self.problem.nu}")
        if verbose and sol is not None:
            print(f"States x:\n{sol.x.cpu().numpy().T}")
            print(f"Controls u:\n{sol.u.cpu().numpy().T}")
            print(f"Cache Kinf:\n{self.cache.Kinf.cpu().numpy()}")
            print(f"Cache Pinf:\n{self.cache.Pinf.cpu().numpy()}")
        return 0

    # -- codegen and persistence ---------------------------------------------

    def codegen(self, output_dir, *, verbose=False):
        """Emit a standalone, dependency-free C++ project with the solver's
        problem, cache, settings and workspace baked in
        (codegen/emitter.py)."""
        self._require_setup()
        emitter.codegen(self, output_dir, verbose=verbose)
        return 0

    def codegen_with_sensitivity(self, output_dir, dK, dP, dC1, dC2, *,
                                 verbose=False):
        """``codegen`` with the given sensitivity matrices: with adaptive
        rho they replace the cache's (and the Taylor maps, which bake them,
        are dropped) and the project carries them; without, they are
        ignored."""
        self._require_setup()
        if self.settings.adaptive_rho:
            self.cache = self.cache.replace(
                dKinf_drho=self._tensor(dK), dPinf_drho=self._tensor(dP),
                dC1_drho=self._tensor(dC1), dC2_drho=self._tensor(dC2))
            self._condensed_taylor_maps = None
        return self.codegen(output_dir, verbose=verbose)

    def save(self, path):
        """Checkpoint the solver (problem, cache, settings, workspace) in the
        JAX package's file format (utils/checkpoint.py)."""
        self._require_setup()
        checkpoint.save(path, self)

    @classmethod
    def load(cls, path, *, device):
        """A solver on ``device`` from a checkpoint written by ``save`` or by
        the JAX package's ``TinyMPCSolver.save``."""
        return checkpoint.load(path, cls, device=device)
