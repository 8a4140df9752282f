"""Profiling helpers (counterpart of tinympc_julia_tpu/utils/profiling.py):
``torch.profiler`` traces, convergence statistics of a solve, timers."""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with ``torch.profiler`` and write a Chrome trace
    (``trace.json``, viewable in Perfetto or chrome://tracing) into
    ``log_dir``.  Host activity is always recorded, and where CUDA is
    available the card's too (kernels with their device times).  Yields the
    profiler, whose ``key_averages()`` sums the events by name."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(v))


def solve_stats(solution) -> dict:
    """Convergence statistics of a (batched) Solution: instances, converged
    count, and the iteration counts' mean, median, 99th percentile and
    maximum."""
    iters = _np(solution.iter)
    solved = _np(solution.solved)
    return dict(
        n=int(iters.size),
        converged=int(solved.sum()),
        iter_mean=float(iters.mean()),
        iter_p50=float(np.percentile(iters, 50)),
        iter_p99=float(np.percentile(iters, 99)),
        iter_max=int(iters.max()),
    )


class Timer:
    """Wall-clock timer of a ``with`` block (host clock; the caller
    synchronises the device inside the block where it times device
    work)."""

    def __init__(self):
        self.t0 = None
        self.elapsed = None

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0


def _cuda_devices(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _cuda_devices(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _cuda_devices(t, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            _cuda_devices(getattr(tree, name), out)
    return out


def timed(fn, *args, sync=True, **kw):
    """Run ``fn(*args, **kw)``; returns (result, seconds).  With ``sync``
    the clock stops after ``torch.cuda.synchronize`` of every card that
    holds an output tensor (the port's ``block_until_ready``), so device
    work is inside the time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    if sync:
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
