"""Carry state between the JAX package and the port through numpy.

Each ``*_from_numpy`` takes a dict of numpy arrays (the JAX pytree's fields
after ``np.asarray``) and returns the port's object with every tensor on the
given device in the given dtype; ``to_numpy`` goes the other way.  A cone set
travels as a dict ``{"mus": array, "starts": ints, "dims": ints}``.

Arrays keep their shapes, so a G-stacked JAX pytree (a leading group axis
on every leaf: problems, caches, condensed and Taylor maps, the grouped
solves' carries) comes out as the port's G-stacked object.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.condensed import (AdaptiveCondensedCarry, CondensedCarry,
                             CondensedMaps, CondensedTaylorMaps)
from ..ops.cuda.adaptive_kernel import AdaptiveFusedCarry
from ..ops.cuda.condensed_kernel import FusedCarry
from ..types import Cache, ConeSet, Problem, State

_PROBLEM_ARRAYS = ("A", "B", "f", "Q", "R", "x_min", "x_max", "u_min",
                   "u_max", "Xref", "Uref", "Alin_x", "blin_x", "Alin_u",
                   "blin_u", "rho_setup")


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def cones_from_numpy(d, *, dtype, device) -> ConeSet:
    """A ConeSet from ``{"mus", "starts", "dims"}`` (numpy and ints);
    ``mus`` is (C,), or (G, C) for a G-stacked cone set."""
    starts = tuple(int(i) for i in d["starts"])
    dims = tuple(int(i) for i in d["dims"])
    mus = np.asarray(d["mus"], float)
    mus = _t(mus if mus.ndim == 2 else mus.reshape(-1), dtype, device)
    if not len(starts) == len(dims) == mus.shape[-1]:
        raise ValueError(f"a cone set needs one start, dim and mu per cone; "
                         f"got {len(starts)}, {len(dims)}, {mus.shape[-1]}")
    return ConeSet(mus=mus, starts=starts, dims=dims)


def problem_from_numpy(d, *, dtype, device) -> Problem:
    """A Problem from its arrays and its two cone sets (``d["cones_x"]``,
    ``d["cones_u"]``, both required)."""
    arrays = {k: _t(d[k], dtype, device) for k in _PROBLEM_ARRAYS}
    return Problem(
        cones_x=cones_from_numpy(d["cones_x"], dtype=dtype, device=device),
        cones_u=cones_from_numpy(d["cones_u"], dtype=dtype, device=device),
        **arrays)


def cache_from_numpy(d, *, dtype, device) -> Cache:
    return Cache(**{f.name: _t(d[f.name], dtype, device)
                    for f in dataclasses.fields(Cache)})


def state_from_numpy(d, *, dtype, device) -> State:
    """A State (single or with leading batch axes); ``status`` and ``iter``
    stay int32."""
    out = {}
    for f in dataclasses.fields(State):
        dt = torch.int32 if f.name in ("status", "iter") else dtype
        out[f.name] = _t(d[f.name], dt, device)
    return State(**out)


def maps_from_numpy(d, *, dtype, device) -> CondensedMaps:
    return CondensedMaps(*(_t(d[k], dtype, device)
                           for k in CondensedMaps._fields))


def taylor_maps_from_numpy(d, *, dtype, device) -> CondensedTaylorMaps:
    return CondensedTaylorMaps(*(_t(d[k], dtype, device)
                                 for k in CondensedTaylorMaps._fields))


def carry_from_numpy(d, *, dtype, device):
    """A FusedCarry from (w2, y, g, v, z), a CondensedCarry from
    (d, y, g, v, z); with a per-lane ``rho`` the adaptive carries: an
    AdaptiveFusedCarry where rho is a (1, B) row beside (dim, B) arrays, an
    AdaptiveCondensedCarry where it is a (B,) vector, or (G, L) beside the
    grouped solve's (G, dim, L) arrays."""
    if "w2" in d:
        cls = FusedCarry
    elif "rho" not in d:
        cls = CondensedCarry
    else:
        cls = (AdaptiveFusedCarry
               if np.ndim(d["rho"]) == 2 and np.ndim(d["d"]) == 2
               else AdaptiveCondensedCarry)
    return cls(*(_t(d[k], dtype, device) for k in cls._fields))


def to_numpy(obj) -> dict:
    """Dict of numpy arrays from a port dataclass or NamedTuple of tensors;
    cone sets become ``{"mus", "starts", "dims"}`` dicts."""
    if dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        items = obj._asdict().items()
    out = {}
    for k, v in items:
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif isinstance(v, ConeSet):
            out[k] = dict(mus=v.mus.detach().cpu().numpy(), starts=v.starts,
                          dims=v.dims)
    return out
