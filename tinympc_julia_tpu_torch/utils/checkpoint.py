"""Solver checkpoint and resume (counterpart of
tinympc_julia_tpu/utils/checkpoint.py), in the JAX package's file format.

A checkpoint is one ``.npz``: the problem's, cache's and workspace's tensors
as ``problem_<i>``, ``cache_<i>`` and ``state_<i>`` in the JAX pytrees' leaf
order (a cone set contributes its ``mus`` only; its starts and dims are
metadata), each in the JAX leaf's dtype, plus a ``__meta__`` JSON with the
dtype's numpy name, the cone structure, the settings and the user data of
``setup``.  A file written by either package loads in the other.

Unlike the JAX package's file, the metadata holds all of the settings: the
JAX writer drops five of them (``relaxation_alpha``,
``adaptive_rho_taylor_trust``, ``adaptive_rho_rebuild``,
``adaptive_rho_controller``, ``bf16_head_iters``), so a solver resumed from
its file solves with their defaults.  A setting missing from a file (one
the JAX package wrote) takes its default here too.

The condensed, Taylor, bucket and chunk maps are not stored: a loaded
solver builds them again when a solve needs them.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .. import types as T

# the JAX pytrees' leaf order: the fields in declaration order, a cone set
# in place as its mus
PROBLEM_LEAVES = ("A", "B", "f", "Q", "R", "x_min", "x_max", "u_min",
                  "u_max", "Xref", "Uref", "Alin_x", "blin_x", "Alin_u",
                  "blin_u", "cones_x", "cones_u", "rho_setup")
CACHE_LEAVES = ("rho", "Kinf", "Pinf", "Quu_inv", "AmBKt", "C1", "C2",
                "dKinf_drho", "dPinf_drho", "dC1_drho", "dC2_drho")
STATE_LEAVES = ("x", "u", "q", "r", "p", "d", "v", "vnew", "z", "znew", "g",
                "y", "primal_residual_state", "primal_residual_input",
                "dual_residual_state", "dual_residual_input", "status",
                "iter")
_CONES = ("cones_x", "cones_u")


def _leaf(obj, name):
    v = getattr(obj, name)
    return (v.mus if isinstance(v, T.ConeSet) else v).detach().cpu().numpy()


def _settings_meta(s: T.Settings) -> dict:
    out = {}
    for f in dataclasses.fields(T.Settings):
        v = getattr(s, f.name)
        out[f.name] = v if isinstance(v, str) else type(f.default)(v)
    return out


def _user_meta(user: dict) -> dict:
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in user.items()}


def save(path, solver) -> None:
    """Write ``solver`` (a set-up TinyMPCSolver) to ``path``."""
    if not solver.is_setup:
        raise RuntimeError("Solver not setup")
    arrays = {}
    for prefix, obj, names in (("problem_", solver.problem, PROBLEM_LEAVES),
                               ("cache_", solver.cache, CACHE_LEAVES),
                               ("state_", solver.state, STATE_LEAVES)):
        for i, name in enumerate(names):
            arrays[f"{prefix}{i}"] = _leaf(obj, name)
    p = solver.problem
    meta = dict(
        version=1,
        dtype=str(solver.dtype).removeprefix("torch."),
        cones_x=dict(starts=list(p.cones_x.starts), dims=list(p.cones_x.dims)),
        cones_u=dict(starts=list(p.cones_u.starts), dims=list(p.cones_u.dims)),
        settings=_settings_meta(solver.settings),
        user=_user_meta(solver._user))
    np.savez(path, __meta__=json.dumps(meta), **arrays)


def load(path, solver_cls, *, device):
    """A ``solver_cls`` (TinyMPCSolver) from the file at ``path``, every
    tensor on ``device``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    dtype = getattr(torch, meta["dtype"])
    device = torch.device(device)

    def tensor(key):
        a = arrays[key]
        t = torch.as_tensor(a, device=device)
        # status and iter keep their integer dtype
        return t.to(dtype) if np.issubdtype(a.dtype, np.floating) else t

    fields = {}
    for i, name in enumerate(PROBLEM_LEAVES):
        t = tensor(f"problem_{i}")
        if name in _CONES:
            c = meta[name]
            t = T.ConeSet(mus=t, starts=tuple(c["starts"]),
                          dims=tuple(c["dims"]))
        fields[name] = t
    solver = solver_cls(dtype=dtype, device=device)
    solver.problem = T.Problem(**fields)
    solver.cache = T.Cache(**{n: tensor(f"cache_{i}")
                              for i, n in enumerate(CACHE_LEAVES)})
    solver.state = T.State(**{n: tensor(f"state_{i}")
                              for i, n in enumerate(STATE_LEAVES)})
    solver.settings = T.Settings(**meta["settings"])
    solver._user = {k: (np.asarray(v) if isinstance(v, list) else v)
                    for k, v in meta["user"].items()}
    solver.is_setup = True
    return solver
