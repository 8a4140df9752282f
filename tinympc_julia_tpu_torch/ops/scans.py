"""Long-horizon forms of the horizon recursions (counterpart of
tinympc_julia_tpu/ops/scans.py).

The backward and forward passes (ops/admm.py) are affine recurrences over
the horizon with a constant matrix,

    s_next = M s + b,

which admit two other forms:

* **Chunked condensation** (``build_chunk_maps``, ``forward_pass_chunked``,
  ``backward_pass_chunked``): the plant is time-invariant, so one map
  condenses C stages and is reused for all (N-1)/C chunks; each chunk is one
  matmul, and the memory is O((C (nx + nu))^2) instead of the full
  condensation's O((N (nx + nu))^2).  This is the path beyond the condensed
  maps' memory budget (``ops.condensed.AUTO_CONDENSED_BUDGET_BYTES``).
* **Associative scans** (``forward_pass_assoc``, ``backward_pass_assoc``):
  the affine maps compose associatively, so all prefix (suffix) composites
  come out of log2(T) doubling steps, each one batched matmul over the
  horizon (a Hillis-Steele scan: PyTorch has no associative scan).

Both give the sequential passes' values up to floating-point reassociation,
not bit for bit; the sequential path is the one golden iterate parity holds
on.  Every function takes leading batch axes on the state, and on the
problem and cache where they differ per instance.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..types import Cache, Problem, State


def _mT(M):
    return M.transpose(-1, -2)


def _apply(M, v):
    """M @ v on the trailing axes; leading batch axes on either."""
    if M.ndim == 2:
        return v @ M.T
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _affine_scan_prefix(M, b):
    """Prefix composites of the forward recurrence x_{i+1} = M x_i + b_i.

    ``M`` (..., n, n), ``b`` (..., T, n).  Returns (Ms (..., T, n, n), bs
    (..., T, n)) with x_{i+1} = Ms[i] @ x_0 + bs[i]: at the doubling step of
    offset k, element i takes the composite of element i - k, applied
    first, and its own."""
    T = b.shape[-2]
    Ms = M.unsqueeze(-3).expand(M.shape[:-2] + (T,) + M.shape[-2:])
    bs = b
    k = 1
    while k < T:
        later_M = Ms[..., k:, :, :]
        Ms_new = later_M @ Ms[..., :-k, :, :]
        bs_new = ((later_M @ bs[..., :-k, :].unsqueeze(-1)).squeeze(-1)
                  + bs[..., k:, :])
        Ms = torch.cat([Ms[..., :k, :, :], Ms_new], dim=-3)
        bs = torch.cat([bs[..., :k, :], bs_new], dim=-2)
        k *= 2
    return Ms, bs


def _affine_scan_suffix(M, b):
    """Suffix composites of the backward recurrence p_i = M p_{i+1} + b_i.

    ``M`` (..., n, n), ``b`` (..., T, n).  Returns (Ms, bs) with p_i =
    Ms[i] @ p_T + bs[i], p_T the terminal value: the prefix scan of the
    reversed sequence, reversed."""
    Ms, bs = _affine_scan_prefix(M, torch.flip(b, dims=(-2,)))
    return torch.flip(Ms, dims=(-3,)), torch.flip(bs, dims=(-2,))


class ChunkMaps(NamedTuple):
    """The chunked horizon path's maps (``build_chunk_maps``); one chunk
    map serves every chunk of a time-invariant plant.

    T1c: the forward chunk map [d_chunk; s; 1] -> [u_chunk; x_{0..C}],
         ``ops.condensed._t1_numpy`` at horizon C + 1.
    Pp:  (C nx, nx)    p_{start+j} = Am^(C-j) p_end + ...
    Pc:  (C nx, C nx)  ... + sum_{k>=j} Am^(k-j) c_{start+k}.
    """
    T1c: torch.Tensor
    Pp: torch.Tensor
    Pc: torch.Tensor


def chunk_size_from_maps(cmaps: ChunkMaps, nx: int, nu: int) -> int:
    """The chunk size C, from the maps' shapes."""
    return (cmaps.T1c.shape[-1] - nx - 1) // nu


def build_chunk_maps(problem: Problem, cache: Cache, C: int) -> ChunkMaps:
    """Build the chunk maps in float64 on the host (numpy), then cast them to
    the problem's dtype and device.  Needs (N - 1) % C == 0."""
    from .condensed import _np64, _t1_numpy

    N = problem.N
    if (N - 1) % C != 0:
        raise ValueError(f"chunk size {C} must divide N-1 = {N - 1}")
    A, B, f = _np64(problem.A), _np64(problem.B), _np64(problem.f)
    K, Am = _np64(cache.Kinf), _np64(cache.AmBKt)
    nx = A.shape[0]

    T1c = _t1_numpy(A, B, f, K, C + 1)
    powers = [np.eye(nx)]
    for _ in range(C):
        powers.append(Am @ powers[-1])
    Pp = np.concatenate([powers[C - j] for j in range(C)], axis=0)
    Pc = np.zeros((C * nx, C * nx))
    for j in range(C):
        for k in range(j, C):
            Pc[j * nx:(j + 1) * nx, k * nx:(k + 1) * nx] = powers[k - j]

    def cast(m):
        return torch.as_tensor(m, dtype=problem.dtype, device=problem.device)

    return ChunkMaps(T1c=cast(T1c), Pp=cast(Pp), Pc=cast(Pc))


def forward_pass_chunked(state: State, problem: Problem, cache: Cache,
                         cmaps: ChunkMaps) -> State:
    """The forward rollout (``admm.forward_pass``) over (N-1)/C chunks,
    each one (C(nx+nu)+nx, C nu+nx+1) matmul from the chunk's start
    state."""
    nx, nu = problem.nx, problem.nu
    C = chunk_size_from_maps(cmaps, nx, nu)
    Nc = (problem.N - 1) // C
    su_c = C * nu
    lead = state.x.shape[:-2]
    d2 = state.d.reshape(lead + (Nc, su_c))
    one = torch.ones(lead + (1,), dtype=state.x.dtype, device=state.x.device)
    s = state.x[..., 0, :]
    us, xs = [], [s.unsqueeze(-2)]
    for k in range(Nc):
        out = _apply(cmaps.T1c, torch.cat([d2[..., k, :], s, one], dim=-1))
        us.append(out[..., :su_c].reshape(lead + (C, nu)))
        x_blk = out[..., su_c + nx:].reshape(lead + (C, nx))  # x_1..x_C
        xs.append(x_blk)
        s = x_blk[..., -1, :]
    return state.replace(x=torch.cat(xs, dim=-2), u=torch.cat(us, dim=-2))


def backward_pass_chunked(state: State, problem: Problem, cache: Cache,
                          cmaps: ChunkMaps) -> State:
    """The backward recursion (``admm.backward_pass``) over (N-1)/C chunks
    from the end: a chunk's p block is two matmuls, then d_i = Quu_inv
    (B^T p_{i+1} + r_i) for the chunk's stages at once."""
    nx, nu = problem.nx, problem.nu
    C = chunk_size_from_maps(cmaps, nx, nu)
    Nc = (problem.N - 1) // C
    lead = state.x.shape[:-2]
    c = state.q[..., :-1, :] - state.r @ cache.Kinf  # q_i - Kinf^T r_i
    c2 = c.reshape(lead + (Nc, C * nx))
    r2 = state.r.reshape(lead + (Nc, C, nu))
    p_N = state.p[..., -1, :]
    QuuT = _mT(cache.Quu_inv)
    ds, ps = [None] * Nc, [None] * Nc
    p_end = p_N
    for k in range(Nc - 1, -1, -1):
        p_blk = _apply(cmaps.Pp, p_end) + _apply(cmaps.Pc, c2[..., k, :])
        p_next = torch.cat([p_blk[..., nx:], p_end],
                           dim=-1).reshape(lead + (C, nx))
        ds[k] = (p_next @ problem.B + r2[..., k, :, :]) @ QuuT
        ps[k] = p_blk.reshape(lead + (C, nx))
        p_end = p_blk[..., :nx]
    return state.replace(d=torch.cat(ds, dim=-2),
                         p=torch.cat(ps + [p_N.unsqueeze(-2)], dim=-2))


def backward_pass_assoc(state: State, problem: Problem, cache: Cache
                        ) -> State:
    """Associative-scan form of ``admm.backward_pass``."""
    c = state.q[..., :-1, :] - state.r @ cache.Kinf  # q_i - Kinf^T r_i
    Ms, bs = _affine_scan_suffix(cache.AmBKt, c)
    p_last = state.p[..., -1, :]
    p_head = (Ms @ p_last[..., None, :, None]).squeeze(-1) + bs
    p = torch.cat([p_head, p_last.unsqueeze(-2)], dim=-2)
    # d_i = Quu_inv (B^T p_{i+1} + r_i): one batched matmul
    d = (p[..., 1:, :] @ problem.B + state.r) @ _mT(cache.Quu_inv)
    return state.replace(d=d, p=p)


def forward_pass_assoc(state: State, problem: Problem, cache: Cache
                       ) -> State:
    """Associative-scan form of ``admm.forward_pass``: x_{i+1} = (A - B
    Kinf) x_i + (f - B d_i), then u_i = -Kinf x_i - d_i."""
    A, B, f, K = problem.A, problem.B, problem.f, cache.Kinf
    M = A - B @ K
    b = f.unsqueeze(-2) - state.d @ _mT(B)
    Ms, bs = _affine_scan_prefix(M, b)
    x0 = state.x[..., 0, :]
    x_tail = (Ms @ x0[..., None, :, None]).squeeze(-1) + bs
    x = torch.cat([x0.unsqueeze(-2), x_tail], dim=-2)
    u = -(x[..., :-1, :] @ _mT(K)) - state.d
    return state.replace(x=x, u=u)
