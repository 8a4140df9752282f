"""Slack-variable projections: box, halfspace, second-order cone
(counterpart of tinympc_julia_tpu/ops/projections.py).

The ADMM slack update projects (u + y, x + g) onto the feasible set.  Every
function acts on the trailing axis of a tensor of any leading shape, with
``torch.where`` selects in place of branches, so the same code serves one
stage vector and a batch of them.

Composition order when several families are enabled:
box -> linear halfspaces -> SOC (the JAX package's documented contract).
"""
from __future__ import annotations

import torch

from ..types import ConeSet


def project_box(w, w_min, w_max):
    """min(w_max, max(w_min, w))."""
    return torch.minimum(torch.as_tensor(w_max, dtype=w.dtype,
                                         device=w.device),
                         torch.maximum(torch.as_tensor(
                             w_min, dtype=w.dtype, device=w.device), w))


def project_halfspaces(w, Alin, blin):
    """Cyclic projection of a stage vector onto each halfspace a_j . w <= b_j,
    rows in order, each seeing the previous row's result:
    w <- w - max(a.w - b, 0) * a / ||a||^2.  ``w`` is (..., n), Alin (m, n),
    blin (m,); or per-instance rows Alin (B, m, n), blin (B, m) on a batch
    of trajectories ``w`` (B, N, n)."""
    if Alin.shape[-2] == 0:
        return w
    tiny = torch.tensor(1e-30, dtype=w.dtype, device=w.device)
    inv_sq = 1.0 / torch.maximum((Alin * Alin).sum(-1), tiny)
    if Alin.ndim == 3:
        for j in range(Alin.shape[1]):
            a = Alin[:, None, j, :]
            viol = torch.clamp_min((w * a).sum(-1) - blin[:, None, j], 0.0)
            w = w - viol[..., None] * (a * inv_sq[:, None, j, None])
        return w
    for a, b, s in zip(Alin, blin, inv_sq):
        viol = torch.clamp_min((w * a).sum(-1) - b, 0.0)
        w = w - viol[..., None] * (a * s)
    return w


def _project_soc_scaled(seg, mu):
    """TinyMPC's projection for the scaled cone ||w[:-1]|| <= mu * w[-1].

    With u0 = mu * w[-1] and a = ||w[:-1]||:
      a <= -u0      -> origin           (below the cone)
      a <=  u0      -> unchanged        (inside)
      otherwise     -> ((a + u0)/(2a)) * [w[:-1]; a / mu]
    """
    v = seg[..., :-1]
    s = seg[..., -1]
    u0 = s * mu
    a = torch.sqrt((v * v).sum(-1))
    safe_a = torch.clamp_min(a, 1e-30)
    factor = (a + u0) / (2.0 * safe_a)
    proj = torch.cat([factor[..., None] * v, (factor * (a / mu))[..., None]],
                     dim=-1)
    below = (a <= -u0)[..., None]
    inside = (a <= u0)[..., None]
    return torch.where(below, torch.zeros_like(seg),
                       torch.where(inside, seg, proj))


def project_soc_exact(seg, mu):
    """Exact Euclidean projection onto {(v, s): ||v|| <= mu * s} (not the
    reference behavior):  s* = (mu ||v|| + s)/(mu^2 + 1),
    v* = mu s* v/||v||."""
    v = seg[..., :-1]
    s = seg[..., -1]
    a = torch.sqrt((v * v).sum(-1))
    safe_a = torch.clamp_min(a, 1e-30)
    coef = (mu * a + s) / (mu * mu + 1.0)
    proj = torch.cat([(coef * mu / safe_a)[..., None] * v, coef[..., None]],
                     dim=-1)
    below = (mu * a <= -s)[..., None]
    inside = (a <= mu * s)[..., None]
    return torch.where(below, torch.zeros_like(seg),
                       torch.where(inside, seg, proj))


def project_cones(w, cones: ConeSet, *, exact: bool = False):
    """Apply every cone of ``cones``, in order, to the trailing axis of
    ``w`` (shape (..., n)); per-instance coefficients ``cones.mus`` (B, C)
    go with a batch of trajectories ``w`` (B, N, n)."""
    if cones.num_cones == 0:
        return w
    proj_fn = project_soc_exact if exact else _project_soc_scaled
    w = w.clone()
    for k, (start, dim) in enumerate(zip(cones.starts, cones.dims)):
        mu = cones.mus[..., k]
        if mu.ndim:
            mu = mu[:, None]
        w[..., start:start + dim] = proj_fn(w[..., start:start + dim], mu)
    return w
