"""Kernel K1 of the port (ops/cuda/condensed_kernel.py): its plain PyTorch
version vs the JAX Pallas kernel (interpret mode off the TPU), vs the port's
condensed oracle, and the wrapper's dispatch on the CPU.  The CUDA kernel
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tinympc_julia_tpu.ops.pallas.condensed_kernel import (
    make_condensed_fused_solver as jax_fused)
from tinympc_julia_tpu_torch.ops import condensed as C
from tinympc_julia_tpu_torch.ops.cuda import _build
from tinympc_julia_tpu_torch.ops.cuda import condensed_kernel as K

from torch_port_common import INTERPRET, cartpole_setup, x0_batch

N = 20
CONFIGS = {
    "ct1-alpha1.7": dict(check_termination=1, relaxation_alpha=1.7,
                         en_state_bound=False, max_iter=80),
    "ct4": dict(check_termination=4, relaxation_alpha=1.7,
                en_state_bound=False, max_iter=80),
    "state-bounded": dict(check_termination=1, relaxation_alpha=1.0,
                          en_state_bound=True, max_iter=120),
}


def _kw(cfg, **extra):
    kw = dict(nx=4, nu=1, N=N, abs_pri_tol=1e-3, abs_dua_tol=1e-3,
              en_input_bound=True, warm_start=False, carry_out=False)
    kw.update(cfg)
    kw.update(extra)
    return kw


def _bounds(p):
    return (p.u_min, p.u_max, p.x_min, p.x_max)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_matches_jax_kernel(name):
    """f32, B = 256, Pallas batch tile 128: more than half the lanes solve;
    on lanes both sides solved, identical counts and 1e-5 on states and
    controls; the carry within 1e-5."""
    cfg = CONFIGS[name]
    B = 256
    (jp, jc, jm), (pp, pc, pm) = cartpole_setup(
        jnp.float32, state_bound=cfg["en_state_bound"])
    x0 = x0_batch(B, 0).astype(np.float32)
    fn = jax_fused(4, 1, N, batch_tile=128, en_input_bound=True,
                   carry_out=True, interpret=INTERPRET, **cfg)
    jx, ju, jit, jok, jcar = fn(jm, jc.rho, jp.u_min, jp.u_max, jp.x_min,
                                jp.x_max, jnp.asarray(x0))
    px, pu, pit, pok, pcar = K.condensed_fused_reference(
        pm, float(pc.rho), *_bounds(pp), torch.as_tensor(x0), None,
        **_kw(cfg, carry_out=True))
    both = (np.asarray(jok) == 1) & (pok.numpy() == 1)
    assert both.sum() > B // 2
    np.testing.assert_array_equal(pit.numpy()[both], np.asarray(jit)[both])
    np.testing.assert_allclose(pu.numpy()[both], np.asarray(ju)[both],
                               atol=1e-5)
    np.testing.assert_allclose(px.numpy()[both], np.asarray(jx)[both],
                               atol=1e-5)
    for k in K.FusedCarry._fields:
        np.testing.assert_allclose(getattr(pcar, k).numpy(),
                                   np.asarray(getattr(jcar, k)), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_matches_condensed_oracle(name):
    """f64: the fused form (one T12 matmul per iteration) and the T1/T2
    condensed solve give identical per-lane counts on every lane."""
    cfg = CONFIGS[name]
    (_, _, _), (pp, pc, pm) = cartpole_setup(
        jnp.float64, state_bound=cfg["en_state_bound"])
    x0 = torch.as_tensor(x0_batch(128, 1, scale=1.0))
    _, pu, pit, pok = K.condensed_fused_reference(
        pm, pc.rho, *_bounds(pp), x0, None, **_kw(cfg))
    s = C.Settings(en_input_bound=True, **{k: cfg[k] for k in (
        "check_termination", "relaxation_alpha", "en_state_bound",
        "max_iter")})
    _, cu, cit, cok = C.solve_condensed(pp, pc, s, x0, pm)
    np.testing.assert_array_equal(pit.numpy(), cit.numpy())
    np.testing.assert_array_equal(pok.numpy(), cok.numpy())
    np.testing.assert_allclose(pu.numpy(), cu.numpy(), atol=1e-9)


@pytest.mark.parametrize("state_bound", [False, True],
                         ids=["state-free", "generic"])
def test_reference_warm_chain_equals_one_shot(state_bound):
    """30 iterations with carry_out, then 50 warm: bit for bit the
    80-iteration solve on every lane."""
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32,
                                             state_bound=state_bound)
    x0 = torch.as_tensor(x0_batch(128, 2, scale=1.0), dtype=torch.float32)
    cfg = dict(check_termination=1, relaxation_alpha=1.7,
               en_state_bound=state_bound)
    args = (pm, float(pc.rho), *_bounds(pp), x0)
    one = K.condensed_fused_reference(*args, None,
                                      **_kw(cfg, max_iter=80))
    xa, ua, ia, sa, carry = K.condensed_fused_reference(
        *args, None, **_kw(cfg, max_iter=30, carry_out=True))
    xb, ub, ib, sb = K.condensed_fused_reference(
        *args, carry, **_kw(cfg, max_iter=50, warm_start=True))
    done = sa == 1
    assert bool(done.any()) and bool((~done & (sb == 1)).any())
    assert torch.equal(torch.where(done, ia, 30 + ib), one[2])
    assert torch.equal(torch.maximum(sa, sb), one[3])
    assert torch.equal(torch.where(done[:, None, None], ua, ub), one[1])
    assert torch.equal(torch.where(done[:, None, None], xa, xb), one[0])
    if not state_bound:
        assert float(carry.g.abs().max()) == 0.0


def test_cpu_solver_runs_the_plain_version_and_builds_nothing():
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.as_tensor(x0_batch(64, 3), dtype=torch.float32)
    before = K.condensed_fused_cuda.launches
    fn = K.make_condensed_fused_solver(4, 1, N, max_iter=40,
                                       relaxation_alpha=1.7)
    out = fn(pm, pc.rho, *_bounds(pp), x0)
    ref = K.condensed_fused_reference(
        pm, pc.rho, *_bounds(pp), x0, None,
        **_kw(dict(check_termination=1, relaxation_alpha=1.7,
                   en_state_bound=False, max_iter=40)))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert K.condensed_fused_cuda.launches == before
    assert _build.load_library.cache_info().currsize == 0
    assert K._kernel_fn.cache_info().currsize == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    x0 = torch.zeros((8, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        K.condensed_fused_cuda(pm, 1.0, *_bounds(pp), x0, None, **_kw(
            dict(check_termination=1, relaxation_alpha=1.0,
                 en_state_bound=False, max_iter=4)))
    assert _build.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("kw,err", [
    (dict(bf16_head_iters=8, check_termination=4, max_iter=48),
     NotImplementedError),
    (dict(precision="default"), NotImplementedError),
    (dict(num_groups=2), NotImplementedError),
    (dict(soc_u=((0, 1, 0.5),)), NotImplementedError),
    (dict(lin_x=(np.ones((1, 4)), np.ones(1))), NotImplementedError),
    (dict(check_termination=3, max_iter=100), ValueError),
], ids=["bf16-head", "precision", "groups", "soc", "linear", "ct"])
def test_unported_and_invalid_options_raise(kw, err):
    with pytest.raises(err):
        K.make_condensed_fused_solver(4, 1, N, **kw)


def test_wrong_inputs_raise():
    (_, _, _), (pp, pc, pm) = cartpole_setup(jnp.float32)
    fn = K.make_condensed_fused_solver(4, 1, N, max_iter=8)
    with pytest.raises(ValueError, match="x0s"):
        fn(pm, pc.rho, *_bounds(pp), torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="warm"):
        fn(pm, pc.rho, *_bounds(pp), torch.zeros((8, 4)),
           K.FusedCarry(*(torch.zeros(1) for _ in range(5))))


def test_tile_plan():
    assert K.fused_tile_plan(4, 1, 20) == (128, True)     # cartpole, sw=99
    assert K.fused_tile_plan(12, 4, 20) == (64, False)    # quadrotor, sw=316
