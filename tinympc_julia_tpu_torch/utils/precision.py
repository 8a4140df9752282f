"""Full fp32 matmuls: the port's counterpart of the JAX package's
``jax.default_matmul_precision("highest")`` and ``Precision.HIGHEST``.

On a CUDA card a float32 matmul may run in TF32 (about three decimal
digits) when ``torch.backends.cuda.matmul.allow_tf32`` is set, as
``torch.set_float32_matmul_precision("high")`` does.  Every fp32 path of the
port that the JAX package pins to HIGHEST (the Riccati cache, the exact rho
rebuild, the reference-ordered and condensed solves, the kernels' plain
versions, the MPC loops) runs inside ``full_fp32_matmul``, so it computes the
same whatever the caller's setting; the kernels never use TF32."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_fp32_matmul():
    """TF32 off for the matmuls inside; the caller's setting is put back on
    exit, also when the body raises.  Usable as a decorator."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
