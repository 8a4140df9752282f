"""Kernel K1 on the card: the CUDA kernel vs its plain PyTorch version, and
the port's main path through it.  Every test here is marked ``cuda`` and
skips where CUDA is not available.  The file imports no JAX, so it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tinympc_julia_tpu_torch import TinyMPCSolver, make_problem
from tinympc_julia_tpu_torch.models import cartpole, quadrotor
from tinympc_julia_tpu_torch.ops.condensed import build_condensed
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K
from tinympc_julia_tpu_torch.ops.riccati import precompute_cache
from tinympc_julia_tpu_torch.parallel import three_phase_solve

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

N = 20


@pytest.fixture
def dev():
    """The first CUDA device; skips where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
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
