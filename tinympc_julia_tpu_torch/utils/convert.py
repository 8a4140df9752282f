"""Carry state between the JAX package and the port through numpy.

Each ``*_from_numpy`` takes a dict of numpy arrays (the JAX pytree's fields
after ``np.asarray``) and returns the port's object with every tensor on the
given device in the given dtype; ``to_numpy`` goes the other way.  Cone sets
are not carried: the port's first slice has none, and the Problem gets empty
ones.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.condensed import CondensedCarry, CondensedMaps
from ..ops.cuda.condensed_kernel import FusedCarry
from ..types import Cache, ConeSet, Problem

_PROBLEM_ARRAYS = ("A", "B", "f", "Q", "R", "x_min", "x_max", "u_min",
                   "u_max", "Xref", "Uref", "Alin_x", "blin_x", "Alin_u",
                   "blin_u", "rho_setup")


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def problem_from_numpy(d, *, dtype, device) -> Problem:
    arrays = {k: _t(d[k], dtype, device) for k in _PROBLEM_ARRAYS}
    empty = ConeSet.empty(dtype, device)
    return Problem(cones_x=empty, cones_u=empty, **arrays)


def cache_from_numpy(d, *, dtype, device) -> Cache:
    return Cache(**{f.name: _t(d[f.name], dtype, device)
                    for f in dataclasses.fields(Cache)})


def maps_from_numpy(d, *, dtype, device) -> CondensedMaps:
    return CondensedMaps(*(_t(d[k], dtype, device)
                           for k in CondensedMaps._fields))


def carry_from_numpy(d, *, dtype, device):
    """A FusedCarry from (w2, y, g, v, z), a CondensedCarry from
    (d, y, g, v, z)."""
    cls = FusedCarry if "w2" in d else CondensedCarry
    return cls(*(_t(d[k], dtype, device) for k in cls._fields))


def to_numpy(obj) -> dict:
    """Dict of numpy arrays from a port dataclass or NamedTuple of tensors
    (cone sets are left out)."""
    if dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        items = obj._asdict().items()
    return {k: v.detach().cpu().numpy() for k, v in items
            if isinstance(v, torch.Tensor)}
