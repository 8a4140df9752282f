"""The port's profiling helpers (utils/profiling.py) against the JAX
package's: ``solve_stats`` gives the same dict from the same solve,
``Timer`` and ``timed`` keep the JAX semantics, and ``trace`` writes a
Chrome trace of the body (host events here; the card's in
tests/test_torch_cuda.py)."""
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from tinympc_julia_tpu.utils import profiling as jprof
from tinympc_julia_tpu_torch.models import cartpole
from tinympc_julia_tpu_torch.utils import profiling as pprof

from torch_port_common import CPU


def _as_numpy(sol):
    return types.SimpleNamespace(iter=sol.iter.numpy(),
                                 solved=sol.solved.numpy())


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_solve_stats_match_jax(batched):
    s = cartpole.make_solver(device=CPU, constrained=True)
    if batched:
        x0s = np.random.default_rng(4).uniform(-1.0, 1.0, (32, 4))
        _, _, iters, solved = s.solve_batch(x0s, method="standard")
        sol = types.SimpleNamespace(iter=iters, solved=solved)
    else:
        s.set_x0([0.5, 0.0, 0.1, 0.0])
        s.solve()
        sol = s.solution
    stats = pprof.solve_stats(sol)
    assert stats == jprof.solve_stats(_as_numpy(sol))
    assert stats["n"] == (32 if batched else 1)
    assert stats["iter_max"] == int(sol.iter.max())


def test_timer_and_timed():
    with pprof.Timer() as t:
        assert t.elapsed is None
        time.sleep(0.01)
    assert t.elapsed >= 0.01
    out, sec = pprof.timed(torch.add, torch.ones(3), 1.0)
    assert torch.equal(out, torch.full((3,), 2.0)) and sec >= 0.0
    out, _ = pprof.timed(lambda: {"a": (torch.zeros(2), 1)}, sync=False)
    assert out["a"][1] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    s = cartpole.make_solver(device=CPU, constrained=True)
    s.set_x0([0.5, 0.0, 0.1, 0.0])
    log_dir = os.path.join(str(tmp_path), "trace")
    with pprof.trace(log_dir) as prof:
        s.solve()
    names = {e.key for e in prof.key_averages()}
    assert "aten::matmul" in names or "aten::mm" in names
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
