"""Cost/memory introspection + profiling helpers.

Replaces the reference's ad-hoc `memory_cost`/`flops` layer properties
(custom_stylegan2/net.py:98-107,150-159, triplane_nerf.py:73-93), the
`profile_memory_stats` entry (models/generator.py:280-300), and the manual
cuda-synchronize timers (NeRF/base.py:49-59) with:

* ``param_count`` / ``param_bytes`` over any variables pytree;
* ``flops_estimate`` via jax's AOT cost analysis (per compiled function —
  exact for the whole graph, not just hand-counted layers);
* ``device_memory_stats`` from the backend allocator;
* ``trace`` context manager around ``jax.profiler`` for per-phase traces.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import jax
import numpy as np


def param_count(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree)
               if hasattr(x, "shape"))


def param_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(tree) if hasattr(x, "shape"))


def flops_estimate(fn, *args, **kwargs) -> Optional[float]:
    """XLA cost-analysis FLOPs of ``jit(fn)`` on the given args."""
    try:
        lowered = jax.jit(fn).lower(*args, **kwargs)
        cost = lowered.compile().cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        return float(cost.get("flops", float("nan")))
    except Exception:
        return None


def device_memory_stats() -> Dict[str, Any]:
    dev = jax.devices()[0]
    stats = getattr(dev, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (device timeline in TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Named wall-clock accumulator with device sync (reference
    NeRF/base.py:49-59 equivalent)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_on=None):
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + \
                (time.perf_counter() - start)
