"""User-facing solver (counterpart of tinympc_julia_tpu/api.py), first slice.

``TinyMPCSolver`` holds a Problem, its Riccati Cache and Settings on one
device, chosen by the caller.  Ported so far: setup, the x0/reference and
bound setters, settings and cache injection, and ``solve_batch`` on the
condensed and fused (kernel K1) paths with exact warm continuation.  Every
other method raises ``NotImplementedError`` naming the ROADMAP.md item that
ports it.

Matrix layout at this boundary follows the reference: states (nx, N),
controls (nu, N-1); ``solve_batch`` returns tensors on the solver's device,
(B, N, nx) and (B, N-1, nu).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import types as T
from .ops import riccati
from .ops.condensed import (auto_uses_condensed, build_condensed,
                            solve_condensed)
from .ops.cuda.condensed_kernel import make_condensed_fused_solver


class MPCSolution(NamedTuple):
    states: np.ndarray    # (nx, N)
    controls: np.ndarray  # (nu, N-1)


@dataclasses.dataclass
class BatchWarmCarry:
    """Opaque warm-start carry of ``solve_batch(return_carry=True)``,
    accepted back as ``warm=``: two chained calls equal one long solve lane
    for lane.  On the fused path it holds the kernel's FusedCarry."""
    method: str
    batch: int
    data: object


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to "
                               f"tinympc_julia_tpu_torch yet ({item})")


class TinyMPCSolver:
    """Stateful wrapper over the functional core, on an explicit device.

        solver = TinyMPCSolver(dtype=torch.float32, device="cuda")
        solver.setup(A, B, f, Q, R, rho, nx, nu, N)
        solver.set_bound_constraints(x_min, x_max, u_min, u_max)
        xs, us, iters, solved = solver.solve_batch(x0s, method="fused")
    """

    def __init__(self, dtype=torch.float64, *, device):
        self.dtype = dtype or torch.float64
        self.device = torch.device(device)
        self.problem: Optional[T.Problem] = None
        self.cache: Optional[T.Cache] = None
        self.settings: T.Settings = T.default_settings()
        self.solution = None
        self.is_setup = False
        self._condensed_maps = None

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
        self._x0 = torch.zeros((nx,), dtype=self.dtype, device=self.device)
        self.solution = None
        self._condensed_maps = None
        self.is_setup = True
        if verbose:
            print(f"TinyMPC solver setup successful (nx={nx}, nu={nu}, N={N})")
        return 0

    def _require_setup(self):
        if not self.is_setup:
            raise RuntimeError("Solver not setup")

    def _tensor(self, a):
        return torch.as_tensor(np.array(a, float, order="C"),
                               dtype=self.dtype, device=self.device)

    # -- state / reference setters -----------------------------------------

    def set_x0(self, x0, *, verbose=False):
        """Initial state of the single-instance ``solve`` (not ported yet)."""
        self._require_setup()
        x0 = self._tensor(np.asarray(x0, float).reshape(-1))
        if x0.shape[0] != self.problem.nx:
            raise ValueError("x0 is not the correct length")
        self._x0 = x0
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
        self._condensed_maps = None
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
        self._condensed_maps = None
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

    def set_linear_constraints(self, *args, **kwargs):
        raise _not_ported("set_linear_constraints", "ROADMAP.md queue 1, "
                          "item 7")

    def set_cone_constraints(self, *args, **kwargs):
        raise _not_ported("set_cone_constraints", "ROADMAP.md queue 1, "
                          "item 7")

    def set_equality_constraints(self, *args, **kwargs):
        raise _not_ported("set_equality_constraints", "ROADMAP.md queue 1, "
                          "item 7")

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
        self._condensed_maps = None
        return 0

    # -- solve ---------------------------------------------------------------

    def solve(self, *, verbose=False, chunked=None):
        raise _not_ported("the single-instance solve (ops/admm.py)",
                          "ROADMAP.md queue 1, item 3")

    def get_solution(self) -> MPCSolution:
        """(states (nx, N), controls (nu, N-1)) of the last ``solve``."""
        self._require_setup()
        if self.solution is None:
            raise RuntimeError("No solution available; call solve() first")
        return MPCSolution(states=np.asarray(self.solution.x).T,
                           controls=np.asarray(self.solution.u).T)

    def _maps(self):
        if self._condensed_maps is None:
            self._condensed_maps = build_condensed(self.problem, self.cache)
        return self._condensed_maps

    def solve_batch(self, x0s, *, method: str = "auto", warm=None,
                    return_carry: bool = False, verbose=False):
        """Batched fresh solves over per-instance initial states (B, nx).

        ``method``: "condensed" (the T1/T2 eager solve), "fused" (kernel K1;
        float32) or "auto" (condensed while the maps fit the memory budget).
        Pass ``return_carry=True`` to also get a ``BatchWarmCarry`` and give
        it back as ``warm=`` (same method, same batch) to continue exactly.

        Returns (xs (B, N, nx), us (B, N-1, nu), iters (B,), solved (B,)) as
        tensors on the solver's device, plus the carry on request."""
        self._require_setup()
        p, s = self.problem, self.settings
        x0s = torch.as_tensor(x0s, dtype=self.dtype, device=self.device)
        B = int(x0s.shape[0])
        if method == "auto":
            if not auto_uses_condensed(p.nx, p.nu, p.N,
                                       adaptive=s.adaptive_rho):
                raise _not_ported("the chunked and standard paths of "
                                  "method='auto'", "ROADMAP.md queue 1, "
                                  "items 8 and 12")
            method = "condensed"
        if method in ("standard", "chunked"):
            raise _not_ported(f"method={method!r}",
                              "ROADMAP.md queue 1, items 8 and 12")
        if method not in ("condensed", "fused"):
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
        if s.adaptive_rho:
            raise _not_ported("adaptive rho", "ROADMAP.md queue 1, item 10")
        if method == "fused":
            out = self._solve_batch_fused(x0s, warm, return_carry)
        else:
            out = solve_condensed(p, self.cache, s, x0s, self._maps(),
                                  warm=None if warm is None else warm.data,
                                  return_carry=True)
            if not return_carry:
                out = out[:4]
        if return_carry:
            return out[:4] + (BatchWarmCarry(method=method, batch=B,
                                             data=out[4]),)
        return out

    def _solve_batch_fused(self, x0s, warm, return_carry):
        """Kernel K1 on the batch as given: the kernel masks its ragged last
        tile and a lane's result does not depend on its tile, so no padding
        is needed."""
        p, s = self.problem, self.settings
        ct = s.check_termination
        if ct < 1 or s.max_iter % ct != 0:
            raise ValueError(
                "the fused path needs check_termination >= 1 dividing "
                f"max_iter (got {ct} / {s.max_iter})")
        if s.bf16_head_iters:
            raise _not_ported("bf16_head_iters", "ROADMAP.md queue 2, K1c")
        if (s.en_state_linear or s.en_input_linear or s.en_state_soc
                or s.en_input_soc):
            raise _not_ported("linear and cone constraints on the fused path",
                              "ROADMAP.md queue 2, K1e")
        if self.dtype != torch.float32:
            raise TypeError("the fused path is float32: build the solver "
                            "with dtype=torch.float32")
        fn = make_condensed_fused_solver(
            p.nx, p.nu, p.N, max_iter=s.max_iter,
            abs_pri_tol=s.abs_pri_tol, abs_dua_tol=s.abs_dua_tol,
            en_state_bound=s.en_state_bound, en_input_bound=s.en_input_bound,
            relaxation_alpha=s.relaxation_alpha, check_termination=ct,
            warm_start=warm is not None, carry_out=return_carry)
        args = (self._maps(), float(self.cache.rho), p.u_min, p.u_max,
                p.x_min, p.x_max, x0s)
        if warm is not None:
            args += (warm.data,)
        return fn(*args)

    # -- not ported yet ------------------------------------------------------

    def solve_batch_rebuild_adaptive(self, *args, **kwargs):
        raise _not_ported("solve_batch_rebuild_adaptive",
                          "ROADMAP.md queue 1, item 11")

    def compute_sensitivity_autograd(self):
        raise _not_ported("compute_sensitivity_autograd",
                          "ROADMAP.md queue 1, item 14")

    def print_problem_data(self, *, verbose=False):
        raise _not_ported("print_problem_data", "ROADMAP.md queue 1, item 14")

    def codegen(self, *args, **kwargs):
        raise _not_ported("codegen", "ROADMAP.md queue 1, item 14")

    def codegen_with_sensitivity(self, *args, **kwargs):
        raise _not_ported("codegen_with_sensitivity",
                          "ROADMAP.md queue 1, item 14")

    def save(self, path):
        raise _not_ported("save", "ROADMAP.md queue 1, item 14")

    @classmethod
    def load(cls, path):
        raise _not_ported("load", "ROADMAP.md queue 1, item 14")
