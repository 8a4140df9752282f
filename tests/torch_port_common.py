"""Shared builders for the tests that hold the PyTorch port
(tinympc_julia_tpu_torch) against the JAX package.

Inputs are made with numpy from a seed and reach both sides as numpy arrays:
the JAX side builds its pytrees, and the port gets the same data through
tinympc_julia_tpu_torch.utils.convert.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import tinympc_julia_tpu as J
from tinympc_julia_tpu.models import cartpole
from tinympc_julia_tpu.ops.condensed import build_condensed as jax_build
from tinympc_julia_tpu_torch.utils import convert

torch.set_num_threads(1)

CPU = torch.device("cpu")
INTERPRET = jax.default_backend() != "tpu"
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}
# the constrained cartpole's state bound: cart position |x_0| <= 2
CART_X_BOUND = np.array([2.0, 1e17, 1e17, 1e17])


def jax_arrays(obj) -> dict:
    """The numpy arrays of a JAX pytree dataclass or NamedTuple (cone sets
    left out)."""
    if dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        items = obj._asdict().items()
    return {k: np.asarray(v) for k, v in items if not hasattr(v, "starts")}


def cartpole_setup(dtype, *, state_bound=False, rho=1.0):
    """(JAX problem, cache, maps) and the port's copies of the same data, for
    the cartpole with |u| <= 5 (and |x_0| <= 2 with ``state_bound``)."""
    N = cartpole.HORIZON
    kw = {}
    if state_bound:
        xb = np.tile(CART_X_BOUND, (N, 1))
        kw = dict(x_min=jnp.asarray(-xb, dtype), x_max=jnp.asarray(xb, dtype))
    jp = J.make_problem(jnp.asarray(cartpole.A, dtype),
                        jnp.asarray(cartpole.B, dtype),
                        jnp.asarray(np.diag(cartpole.Q_DIAG), dtype),
                        jnp.asarray(np.diag(cartpole.R_DIAG), dtype),
                        rho, N, u_min=-5.0, u_max=5.0, **kw)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(rho, dtype))
    jm = jax_build(jp, jc)
    tdt = TORCH_DTYPE[dtype]
    pp = convert.problem_from_numpy(jax_arrays(jp), dtype=tdt, device=CPU)
    pc = convert.cache_from_numpy(jax_arrays(jc), dtype=tdt, device=CPU)
    pm = convert.maps_from_numpy(jax_arrays(jm), dtype=tdt, device=CPU)
    return (jp, jc, jm), (pp, pc, pm)


def x0_batch(B, seed, scale=0.5, nx=4):
    return np.random.default_rng(seed).uniform(-scale, scale, size=(B, nx))

