"""Sanitizer tier: NaN/overflow checking and determinism harness.

Reference counterpart: none in-repo (the CUDA project would use external
cuda-memcheck / compute-sanitizer, SURVEY.md §5.2).  Here races are designed
out (pure functional steps); this module provides the remaining sanitizer
needs:

  * ``checked_step`` — jax.experimental.checkify wrapper that turns NaN /
    overflow-counter violations into hard errors with payloads;
  * ``assert_deterministic`` — same state twice -> bitwise-equal results
    (a race detector's analog).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from ..models.params import SimParams
from ..models.state import State


def checked_step(params: SimParams, method: str = "pallas") -> Callable:
    """Returns step(state) that raises on NaN positions or capacity overflow.

    Usage::
        step = checked_step(params)
        err, state = step(state); err.throw()
    """
    from ..models import solver
    fn = solver._METHODS[method]

    def body(state: State) -> State:
        out = fn(state, params)
        checkify.check(jnp.all(jnp.isfinite(out.pos)),
                       "non-finite positions after step")
        checkify.check(jnp.all(jnp.isfinite(out.vel)),
                       "non-finite velocities after step")
        checkify.check(out.overflow == 0,
                       "cell-capacity overflow: {n} particles dropped "
                       "(raise SimParams.cell_capacity)", n=out.overflow)
        return out

    return jax.jit(checkify.checkify(body))


def assert_deterministic(params: SimParams, state: State, n_steps: int = 10,
                         method: str = "pallas") -> None:
    """Race-detector analog: identical inputs must give bitwise-equal
    trajectories (SURVEY.md §4: determinism as the sanitizer tier)."""
    import numpy as np
    from ..models.solver import run

    a = run(state, params, n_steps, method=method)
    b = run(state, params, n_steps, method=method)
    for name, x, y in zip(State._fields, a, b):
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            raise AssertionError(f"nondeterministic field {name!r} after "
                                 f"{n_steps} steps with method={method!r}")
