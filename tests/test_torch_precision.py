"""The port's full-fp32 matmul pin (the JAX package's HIGHEST precision) and
its top-level exports.

Every entry point that the JAX package runs at ``Precision.HIGHEST`` runs
its matmuls with ``torch.backends.cuda.matmul.allow_tf32`` off, whatever the
caller set, and puts the caller's setting back after the call, also when the
call raises.  A TorchFunctionMode records the flag at every matmul of a call
on the CPU (the flag is process-wide, so what it reads is what a CUDA matmul
would see)."""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import tinympc_julia_tpu_torch as P
from tinympc_julia_tpu_torch.models import cartpole
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.ops.cuda import adaptive_kernel as K2
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.ops.cuda import fused as K3
from tinympc_julia_tpu_torch.parallel import batch as PB
from tinympc_julia_tpu_torch.parallel import mpc
from tinympc_julia_tpu_torch.utils.precision import full_fp32_matmul

torch.set_num_threads(1)

N = cartpole.HORIZON
CPU = torch.device("cpu")
MATMULS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
           torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.mv,
           torch.einsum, torch.linalg.solve, torch.linalg.inv}


class FlagAtMatmuls(TorchFunctionMode):
    """Records ``allow_tf32`` at every matmul-like call inside."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in MATMULS:
            self.seen.append(torch.backends.cuda.matmul.allow_tf32)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def tf32_on():
    """The caller's setting: TF32 allowed, as after
    ``torch.set_float32_matmul_precision("high")``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _plant(dtype=torch.float32, rho=1.0):
    p = P.make_problem(cartpole.A, cartpole.B, np.diag(cartpole.Q_DIAG),
                       np.diag(cartpole.R_DIAG), rho, N, u_min=-5.0,
                       u_max=5.0, dtype=dtype, device=CPU)
    with full_fp32_matmul():
        c = P.precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)
    return p, c


def _x0(B=6, dtype=torch.float32):
    return torch.as_tensor(np.random.default_rng(0).uniform(
        -0.4, 0.4, size=(B, 4)), dtype=dtype)


def _fused_kw(**kw):
    full = dict(nx=4, nu=1, N=N, max_iter=8, abs_pri_tol=1e-3,
                abs_dua_tol=1e-3, en_state_bound=False, en_input_bound=True,
                relaxation_alpha=1.7, check_termination=4, warm_start=False,
                carry_out=False)
    full.update(kw)
    return full


def _riccati():
    p, _ = _plant()
    P.precompute_cache(p.A, p.B, p.Q, p.R, p.rho_setup)


def _rebuild():
    p, c = _plant()
    P.rho_adaptation.rebuild_update(c, p, 2.0)


def _admm():
    p, c = _plant(torch.float64)
    st = P.init_state(4, 1, N, device=CPU)
    x = st.x.clone()
    x[0] = _x0(1, torch.float64)[0]
    P.solve(p, c, P.Settings(max_iter=10), st.replace(x=x))


def _batch():
    p, c = _plant(torch.float64)
    st = PB.set_x0_batch(PB.broadcast_state(
        P.init_state(4, 1, N, device=CPU), 3), _x0(3, torch.float64))
    PB.solve_batch(p, c, P.Settings(max_iter=10), st)


def _condensed():
    p, c = _plant()
    C.solve_condensed(p, c, P.Settings(max_iter=10), _x0())


def _condensed_adaptive():
    p, c = _plant(torch.float64)
    C.solve_condensed_adaptive(
        p, c, P.Settings(max_iter=10, adaptive_rho=True), _x0(4, torch.float64))


def _k1_plain():
    p, c = _plant()
    K.condensed_fused_reference(C.build_condensed(p, c), float(c.rho),
                                p.u_min, p.u_max, p.x_min, p.x_max, _x0(),
                                **_fused_kw())


def _k2_plain():
    p, c = _plant()
    K2.condensed_adaptive_reference(
        C.build_condensed_taylor(p, c), p.u_min, p.u_max, p.x_min, p.x_max,
        _x0(), None, plant=K2.AdaptivePlant(p.A, p.B, p.Q, p.R, c.Pinf,
                                            c.dPinf_drho),
        adaptive_rho_min=0.5, adaptive_rho_max=5.0,
        adaptive_rho_clipping=True, controller="osqp",
        taylor_trust=float("inf"), **_fused_kw(max_iter=10,
                                               relaxation_alpha=1.0,
                                               check_termination=1))


def _k3_plain():
    p, c = _plant()
    K3.fused_reference(p.A, p.B, p.f, p.Q, p.R, c.rho, c.Kinf, c.Quu_inv,
                       c.AmBKt, c.Pinf, p.x_min, p.x_max, p.u_min, p.u_max,
                       p.Xref, p.Uref, _x0(), nx=4, nu=1, N=N, max_iter=8,
                       abs_pri_tol=1e-3, abs_dua_tol=1e-3,
                       en_state_bound=False, en_input_bound=True,
                       check_termination=1)


def _mpc_loops():
    p, c = _plant(torch.float64)
    s = P.Settings(max_iter=20, en_state_bound=False)
    mpc.run_mpc_loop(p, c, s, _x0(2, torch.float64), 2)
    mpc.run_mpc_loop_condensed(p, c, s, _x0(2, torch.float64), 2)
    p32, c32 = _plant()
    mpc.make_fused_mpc_loop(p32, c32, s, 2)(_x0(2))


ENTRY_POINTS = {
    "riccati.precompute_cache": _riccati,
    "rho.rebuild_update": _rebuild,
    "admm.solve": _admm,
    "batch.solve_batch": _batch,
    "condensed.solve_condensed": _condensed,
    "condensed.solve_condensed_adaptive": _condensed_adaptive,
    "condensed_fused_reference (K1 plain)": _k1_plain,
    "condensed_adaptive_reference (K2 plain)": _k2_plain,
    "fused_reference (K3 plain)": _k3_plain,
    "the three MPC loops": _mpc_loops,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_runs_without_tf32_and_restores_the_flag(tf32_on, name):
    spy = FlagAtMatmuls()
    with spy:
        ENTRY_POINTS[name]()
    assert spy.seen, f"{name} ran no matmul"
    assert not any(spy.seen), f"{name} ran a matmul with TF32 allowed"
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_flag_is_restored_when_the_call_raises(tf32_on):
    p, c = _plant()
    with pytest.raises(ValueError, match="x0s"):
        K.condensed_fused_reference(C.build_condensed(p, c), float(c.rho),
                                    p.u_min, p.u_max, p.x_min, p.x_max,
                                    torch.zeros((4, 3)), **_fused_kw())
    assert torch.backends.cuda.matmul.allow_tf32 is True
    with pytest.raises(RuntimeError, match="inside"):
        with full_fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            raise RuntimeError("inside")
    assert torch.backends.cuda.matmul.allow_tf32 is True


def test_flag_off_stays_off():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _k1_plain()
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_top_level_exports_are_the_ports_own_objects():
    import sys
    assert P.solve is P.admm.solve
    assert P.rho_adaptation is P.ops.rho
    assert P.admm is P.ops.admm and P.riccati is P.ops.riccati
    assert P.projections is P.ops.projections
    assert "solve" in P.__all__
    assert all(not m.startswith("tinympc_julia_tpu.")
               for m in (P.solve.__module__, P.rho_adaptation.__name__,
                         P.projections.__name__))
    assert "tinympc_julia_tpu_torch" in sys.modules
