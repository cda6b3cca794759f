"""Tracing / profiling utilities.

Reference counterpart: CUDA event timers + external nvprof (SURVEY.md §5.1).
Here: a step timer that fences with ``block_until_ready``, compiled cost
analysis, and `jax.profiler` traces (TensorBoard/Perfetto).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax


def step_time(step_fn: Callable, init_state, k: int = 10,
              reps: int = 3) -> float:
    """Seconds per step_fn application (state -> state, pure).

    Runs k applications inside one jitted fori_loop; the first call
    compiles and warms, then the best of ``reps`` calls, each fenced with
    ``block_until_ready`` on the whole output, is divided by k.
    """
    f = jax.jit(lambda s: jax.lax.fori_loop(0, k, lambda i, s: step_fn(s),
                                            s))
    jax.block_until_ready(f(init_state))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(init_state))
        best = min(best, time.perf_counter() - t0)
    return max(best / k, 1e-12)


def cost_analysis(fn: Callable, *args) -> Dict:
    """XLA cost analysis of a jitted function (flops, bytes accessed)."""
    lowered = jax.jit(fn).lower(*args)
    compiled = lowered.compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, list):                   # older jax returns [dict]
        costs = costs[0] if costs else {}
    keep = {}
    for key in ("flops", "bytes accessed", "transcendentals",
                "utilization operand 0 {}"):
        if costs and key in costs:
            keep[key] = costs[key]
    return keep or dict(costs or {})


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context -> TensorBoard/Perfetto dump in logdir."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
