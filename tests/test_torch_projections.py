"""The port's ops/projections.py vs the JAX package's, float64, at 1e-12:
box, cyclic halfspaces and the scaled and exact second-order cones, with
the cases of tests/test_constraints.py (inside, below, boundary, offset)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tinympc_julia_tpu import ConeSet as JConeSet
from tinympc_julia_tpu.ops import projections as JP
from tinympc_julia_tpu_torch import ConeSet
from tinympc_julia_tpu_torch.ops import projections as PP

from torch_port_common import CPU

ATOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a, float), device=CPU)


def _cones(mus, starts, dims):
    return (JConeSet(mus=jnp.asarray(mus, jnp.float64), starts=starts,
                     dims=dims),
            ConeSet(mus=_t(mus), starts=starts, dims=dims))


def test_box():
    w = np.random.default_rng(0).normal(scale=3.0, size=(5, 4))
    lo, hi = -np.ones(4), np.array([2.0, 0.5, 1.0, 3.0])
    np.testing.assert_array_equal(
        PP.project_box(_t(w), _t(lo), _t(hi)).numpy(),
        np.asarray(JP.project_box(jnp.asarray(w), lo, hi)))
    np.testing.assert_array_equal(PP.project_box(_t(w), -1.0, 2.0).numpy(),
                                  np.asarray(JP.project_box(jnp.asarray(w),
                                                            -1.0, 2.0)))


@pytest.mark.parametrize("w,A,b", [
    ([0.0, 0.0], [[1.0, 0.0]], [1.0]),                     # inactive
    ([2.0, 0.0], [[1.0, 0.0]], [1.0]),                     # active
    ([2.0, 2.0], [[1.0, 0.0], [0.0, 1.0]], [1.0, 0.5]),    # cyclic
    ([3.0, -1.0, 2.0], [[1.0, 1.0, 0.0], [0.0, 2.0, 1.0],
                        [1.0, 0.0, -1.0]], [1.0, 0.3, 0.2]),  # rows interact
], ids=["inactive", "active", "sequential", "three-rows"])
def test_halfspaces(w, A, b):
    got = PP.project_halfspaces(_t(w), _t(A), _t(b)).numpy()
    want = np.asarray(JP.project_halfspaces(jnp.asarray(w), jnp.asarray(A),
                                            jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_halfspaces_batched_and_empty():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(7, 4))
    A, b = rng.normal(size=(3, 4)), rng.normal(size=3)
    np.testing.assert_allclose(
        PP.project_halfspaces(_t(w), _t(A), _t(b)).numpy(),
        np.asarray(JP.project_halfspaces(jnp.asarray(w), jnp.asarray(A),
                                         jnp.asarray(b))), atol=ATOL)
    empty = PP.project_halfspaces(_t(w), torch.zeros((0, 4),
                                                     dtype=torch.float64),
                                  torch.zeros(0, dtype=torch.float64))
    np.testing.assert_array_equal(empty.numpy(), w)


@pytest.mark.parametrize("w,mu,start", [
    ([0.1, 0.1, 1.0], 1.0, 0),             # inside: unchanged
    ([0.1, 0.0, -5.0], 1.0, 0),            # below: the origin
    ([1.0, 0.0, 0.0], 1.0, 0),             # onto the boundary
    ([9.0, 1.0, 0.0, 0.0, 9.0], 1.0, 1),   # offset cone on [1:4)
    ([3.0, -2.0, 1.0], 0.25, 0),           # the thrust cone's coefficient
    ([0.0, 0.0, 0.0], 0.5, 0),             # the apex (a = 0)
], ids=["inside", "below", "boundary", "offset", "mu0.25", "apex"])
def test_cones(w, mu, start):
    jc, pc = _cones([mu], (start,), (3,))
    got = PP.project_cones(_t(w), pc).numpy()
    want = np.asarray(JP.project_cones(jnp.asarray(w), jc))
    np.testing.assert_allclose(got, want, atol=ATOL)
    got_x = PP.project_cones(_t(w), pc, exact=True).numpy()
    want_x = np.asarray(JP.project_cones(jnp.asarray(w), jc, exact=True))
    np.testing.assert_allclose(got_x, want_x, atol=ATOL)


def test_two_cones_on_random_stages_land_in_the_cone():
    """Two cones on a stacked batch of stage vectors: equal to JAX, and the
    scaled projection lands inside ||v|| <= mu s."""
    w = np.random.default_rng(2).normal(scale=5.0, size=(50, 7))
    jc, pc = _cones([0.25, 0.5], (0, 3), (3, 4))
    got = PP.project_cones(_t(w), pc).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JP.project_cones(jnp.asarray(w), jc)), atol=ATOL)
    assert (np.linalg.norm(got[:, :2], axis=1)
            <= 0.25 * got[:, 2] + 1e-9).all()
    assert (np.linalg.norm(got[:, 3:6], axis=1)
            <= 0.5 * got[:, 6] + 1e-9).all()
    np.testing.assert_array_equal(PP.project_cones(_t(w), ConeSet.empty(
        torch.float64, CPU)).numpy(), w)


def test_soc_exact_metric():
    got = PP.project_soc_exact(_t([1.0, 0.0, 1.0]), 0.5).numpy()
    np.testing.assert_allclose(got, [0.6, 0.0, 1.2], atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(JP.project_soc_exact(jnp.asarray([1.0, 0.0, 1.0]),
                                             0.5)), atol=ATOL)
