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
from tinympc_julia_tpu.ops.condensed import build_condensed_taylor
from tinympc_julia_tpu_torch.utils import convert

torch.set_num_threads(1)

CPU = torch.device("cpu")
INTERPRET = jax.default_backend() != "tpu"
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.float64: torch.float64}
# the constrained cartpole's state bound: cart position |x_0| <= 2
CART_X_BOUND = np.array([2.0, 1e17, 1e17, 1e17])


def jax_cones(cones) -> dict:
    """A JAX ConeSet as the port's converters take it."""
    return dict(mus=np.asarray(cones.mus), starts=tuple(cones.starts),
                dims=tuple(cones.dims))


def jax_arrays(obj) -> dict:
    """The numpy arrays of a JAX pytree dataclass or NamedTuple; a cone set
    becomes a ``{"mus", "starts", "dims"}`` dict."""
    if dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        items = obj._asdict().items()
    return {k: jax_cones(v) if hasattr(v, "starts") else np.asarray(v)
            for k, v in items}


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


def port_copies(jp, jc, dtype):
    """The port's Problem and Cache of a JAX problem and cache."""
    tdt = TORCH_DTYPE[dtype]
    return (convert.problem_from_numpy(jax_arrays(jp), dtype=tdt, device=CPU),
            convert.cache_from_numpy(jax_arrays(jc), dtype=tdt, device=CPU))


def taylor_setup(model, dtype, *, rho, ub, N=20, state_bound=None, order=2):
    """(JAX problem, cache, Taylor maps) and the port's copies, for a plant
    module (cartpole, quadrotor) with |u| <= ub and, with ``state_bound``
    (nx,), |x| <= state_bound at every stage."""
    kw = {}
    if state_bound is not None:
        xb = np.tile(state_bound, (N, 1))
        kw = dict(x_min=jnp.asarray(-xb, dtype), x_max=jnp.asarray(xb, dtype))
    jp = J.make_problem(jnp.asarray(model.A, dtype),
                        jnp.asarray(model.B, dtype),
                        jnp.asarray(np.diag(model.Q_DIAG), dtype),
                        jnp.asarray(np.diag(model.R_DIAG), dtype),
                        rho, N, u_min=-ub, u_max=ub, **kw)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R, jnp.asarray(rho, dtype))
    jt = build_condensed_taylor(jp, jc, order=order)
    pp, pc = port_copies(jp, jc, dtype)
    pt = convert.taylor_maps_from_numpy(jax_arrays(jt),
                                        dtype=TORCH_DTYPE[dtype], device=CPU)
    return (jp, jc, jt), (pp, pc, pt)


def x0_batch(B, seed, scale=0.5, nx=4):
    return np.random.default_rng(seed).uniform(-scale, scale, size=(B, nx))


def rocket_setup(dtype, *, state_bound=True, mu_x=None):
    """(JAX problem, cache, maps) and the port's copies for the rocket lander
    with its box, thrust cone and glide-slope cone and the reference at step
    0 (the JAX bench row's configuration; ``mu_x`` overrides the glide-slope
    coefficient, ``state_bound=False`` drops the state box)."""
    from tinympc_julia_tpu.models import rocket
    N = rocket.HORIZON
    x_min, x_max, _, _ = rocket.bounds()
    kw = {}
    if state_bound:
        kw = dict(x_min=jnp.asarray(x_min.T, dtype),
                  x_max=jnp.asarray(x_max.T, dtype))
    Xref, Uref = rocket.reference_trajectory(0)
    cone = lambda mu: J.ConeSet(mus=jnp.asarray([mu], dtype), starts=(0,),
                                dims=(3,))
    jp = J.make_problem(jnp.asarray(rocket.A, dtype),
                        jnp.asarray(rocket.B, dtype),
                        jnp.asarray(np.diag(rocket.Q_DIAG), dtype),
                        jnp.asarray(np.diag(rocket.R_DIAG), dtype),
                        rocket.RHO, N, f=jnp.asarray(rocket.F, dtype),
                        u_min=-10.0, u_max=105.0,
                        Xref=jnp.asarray(Xref.T, dtype),
                        Uref=jnp.asarray(Uref.T, dtype),
                        cones_u=cone(rocket.MU_INPUT),
                        cones_x=cone(rocket.MU_STATE if mu_x is None
                                     else mu_x), **kw)
    jc = J.precompute_cache(jp.A, jp.B, jp.Q, jp.R,
                            jnp.asarray(rocket.RHO, dtype))
    jm = jax_build(jp, jc)
    tdt = TORCH_DTYPE[dtype]
    pp = convert.problem_from_numpy(jax_arrays(jp), dtype=tdt, device=CPU)
    pc = convert.cache_from_numpy(jax_arrays(jc), dtype=tdt, device=CPU)
    pm = convert.maps_from_numpy(jax_arrays(jm), dtype=tdt, device=CPU)
    return (jp, jc, jm), (pp, pc, pm)


def rocket_x0(B, seed=2):
    """The bench row's initial states: X_INIT scaled by U(0.9, 1.1)."""
    from tinympc_julia_tpu.models import rocket
    return rocket.X_INIT[None, :] * np.random.default_rng(seed).uniform(
        0.9, 1.1, size=(B, 1))


def jax_stack(trees):
    """Stack JAX pytrees along a new leading group axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def grouped_cartpoles(G, dtype, *, N=8, seed=0, state_bound=False,
                      randomize_rho=True):
    """G randomised cartpoles (perturbed plant, costs, input bounds,
    references and rho; with ``state_bound`` a per-group bound on the cart
    position) as G-stacked JAX (problems, caches) and the port's copies."""
    rng = np.random.default_rng(seed)
    probs, caches = [], []
    for _ in range(G):
        A = np.asarray(cartpole.A) + rng.normal(scale=2e-3, size=(4, 4))
        B = np.asarray(cartpole.B) * rng.uniform(0.9, 1.1)
        Qd = np.asarray(cartpole.Q_DIAG) * rng.uniform(0.8, 1.25, size=4)
        Rd = np.asarray(cartpole.R_DIAG) * rng.uniform(0.8, 1.25, size=1)
        ub = rng.uniform(3.0, 6.0)
        rho = float(rng.uniform(0.8, 1.5)) if randomize_rho else 1.0
        kw = {}
        if state_bound:
            xb = np.tile(np.array([rng.uniform(0.3, 0.6), 1e17, 1e17, 1e17]),
                         (N, 1))
            kw = dict(x_min=jnp.asarray(-xb, dtype),
                      x_max=jnp.asarray(xb, dtype))
        p = J.make_problem(jnp.asarray(A, dtype), jnp.asarray(B, dtype),
                           jnp.asarray(np.diag(Qd), dtype),
                           jnp.asarray(np.diag(Rd), dtype), rho, N,
                           u_min=-ub, u_max=ub,
                           Xref=jnp.asarray(rng.normal(scale=0.02,
                                                       size=(N, 4)), dtype),
                           **kw)
        probs.append(p)
        caches.append(J.precompute_cache(p.A, p.B, p.Q, p.R,
                                         jnp.asarray(rho, dtype)))
    jps, jcs = jax_stack(probs), jax_stack(caches)
    return (jps, jcs), port_copies(jps, jcs, dtype)


def grouped_rockets(G, dtype, *, seed=6):
    """G rocket landers with per-group cone coefficients (the JAX bench
    row's draw: thrust mu ~ U(0.15, 0.35), glide-slope mu ~ U(0.4, 0.6)) as
    G-stacked JAX (problems, caches) and the port's copies."""
    from tinympc_julia_tpu.models import rocket
    rng = np.random.default_rng(seed)
    N = rocket.HORIZON
    xb = rocket.bounds()
    Xref, Uref = rocket.reference_trajectory(0)
    probs, caches = [], []
    for _ in range(G):
        mu_u = float(rng.uniform(0.15, 0.35))
        mu_x = float(rng.uniform(0.4, 0.6))
        cone = lambda mu: J.ConeSet(mus=jnp.asarray([mu], dtype),
                                    starts=(0,), dims=(3,))
        p = J.make_problem(
            jnp.asarray(rocket.A, dtype), jnp.asarray(rocket.B, dtype),
            jnp.asarray(np.diag(rocket.Q_DIAG), dtype),
            jnp.asarray(np.diag(rocket.R_DIAG), dtype), rocket.RHO, N,
            f=jnp.asarray(rocket.F, dtype), x_min=jnp.asarray(xb[0].T, dtype),
            x_max=jnp.asarray(xb[1].T, dtype), u_min=-10.0, u_max=105.0,
            Xref=jnp.asarray(Xref.T, dtype), Uref=jnp.asarray(Uref.T, dtype),
            cones_u=cone(mu_u), cones_x=cone(mu_x))
        probs.append(p)
        caches.append(J.precompute_cache(p.A, p.B, p.Q, p.R,
                                         jnp.asarray(rocket.RHO, dtype)))
    jps, jcs = jax_stack(probs), jax_stack(caches)
    return (jps, jcs), port_copies(jps, jcs, dtype)


def settings_pair(**kw):
    """The same Settings for the JAX package and the port."""
    import tinympc_julia_tpu_torch as P
    return J.Settings(**kw), P.Settings(**kw)
