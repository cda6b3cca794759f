"""The step engine: State -> State, whole trajectories under one lax.scan.

Reference counterpart: ``ParticleSystem::update(dt)`` — the host loop that
launches calcHash / sort / reorder / density / forces / integrate per frame
(SURVEY.md §3.1).  Here there is no host orchestration at all: ``step`` is a
pure function and ``run`` jits ``lax.scan(step)``, so an entire K-step
rollout is ONE device program with zero host round-trips per frame.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import naive, physics
from .params import SimParams
from .state import State

# method name -> step implementation registry; gridded/pallas register here.
_METHODS = {}


def register_method(name: str):
    def deco(fn):
        _METHODS[name] = fn
        return fn
    return deco


@register_method("naive")
def _step_naive(state: State, params: SimParams) -> State:
    pos, vel, rho, pres = naive.step_naive(state.pos, state.vel, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=state.ids,
                 overflow=jnp.zeros((), jnp.int32))


@register_method("gridded")
def _step_gridded(state: State, params: SimParams) -> State:
    from ..ops import gridded
    pos, vel, rho, pres, overflow = gridded.step_gridded(
        state.pos, state.vel, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=state.ids,
                 overflow=overflow)


@register_method("pallas")
def _step_pallas(state: State, params: SimParams) -> State:
    from ..ops import pallas_sph
    pos, vel, rho, pres, ids, overflow = pallas_sph.step_pallas(
        state.pos, state.vel, state.ids, params)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                 overflow=overflow)


@register_method("pallas_inc")
def _step_pallas_inc(state: State, params: SimParams) -> State:
    # single-step facade; multi-step rollouts dispatch to inc.run_inc in
    # run() so the planes stay resident across the whole scan (the point
    # of the incremental path)
    from ..ops import inc
    return inc.run_inc(state, params, 1)


@register_method("pallas_inc_cont")
def _step_pallas_inc_cont(state: State, params: SimParams) -> State:
    # continuity-density tier: the density sweep drops out of the step —
    # rho rides in the planes and is advanced by the force sweep
    # (ops/inc.py step_planes continuity mode).  CAVEAT (like pallas_inc's conversion cost, but
    # worse): this single-step facade re-converts flat->planes per call,
    # which resets the resum age to 0 — so repeated solver.step() calls
    # pay a summation-density resum EVERY step and never reach the
    # steady-state continuity formulation.  Use run()/rollout() (which
    # dispatch to inc.run_inc and keep the planes + age resident across
    # the whole scan) for anything longer than one step.
    from ..ops import inc
    return inc.run_inc(state, params, 1, continuity=True)


def step(state: State, params: SimParams, method: str = "auto") -> State:
    """One SPH step. method: 'naive' | 'gridded' | 'pallas' | 'auto'."""
    return _METHODS[resolve_method(method, state.n)](state, params)


def resolve_method(method: str, n: int) -> str:
    if method != "auto":
        if method not in _METHODS:
            raise ValueError(
                f"unknown method {method!r}; available: "
                f"{sorted(_METHODS)} or 'auto'")
        return method
    if n <= 8192 or "gridded" not in _METHODS:
        return "naive"
    return "pallas" if "pallas" in _METHODS else "gridded"


@functools.partial(jax.jit, static_argnames=("params", "n_steps", "method"))
def _run_scan(state: State, params: SimParams, n_steps: int,
                    method: str) -> State:
    fn = _METHODS[method]
    return jax.lax.scan(lambda s, _: (fn(s, params), None),
                        state, None, length=n_steps)[0]


def run(state: State, params: SimParams, n_steps: int,
        method: str = "auto") -> State:
    """Advance ``n_steps`` in one jitted lax.scan device program.

    'auto' picks the incremental (planes-resident) pipeline for long
    rollouts at scale — its per-rollout conversion (one full sort) is
    amortized over the steps, and each step then re-sorts only the
    particles that changed cell; overflow semantics are identical.
    """
    auto = method == "auto"
    method = resolve_method(method, state.n)
    if auto and method == "pallas" and n_steps >= 16 and state.n > 32768:
        method = "pallas_inc"
    if method in ("pallas_inc", "pallas_inc_cont"):
        from ..ops import inc
        return inc.run_inc(state, params, n_steps,
                           continuity=method == "pallas_inc_cont")
    return _run_scan(state, params, n_steps, method)


def rollout(state: State, params: SimParams, n_steps: int,
            method: str = "auto", record_every: int = 1):
    """Like ``run`` but stacks recorded states: returns (final, traj).

    traj has shape (n_steps//record_every, N, dim) — position snapshots for
    rendering/export.  NOTE: the pallas path keeps particles cell-sorted, so
    row i of different frames may be different particles; snapshots are
    set-valued (fine for rasterization/statistics).  For per-particle
    trajectories run stepwise and re-align by ``State.ids``.

    'pallas_inc' (or 'auto' at scale) records frames INSIDE the
    planes-resident scan (inc.rollout_inc) — one flat<->planes conversion
    per rollout, not per step.
    """
    auto = method == "auto"
    method = resolve_method(method, state.n)
    if auto and method == "pallas" and n_steps >= 16 and state.n > 32768:
        method = "pallas_inc"
    if method in ("pallas_inc", "pallas_inc_cont"):
        from ..ops import inc
        return inc.rollout_inc(state, params, n_steps, record_every,
                               continuity=method == "pallas_inc_cont")
    return _rollout_scan(state, params, n_steps, method, record_every)


@functools.partial(jax.jit,
                   static_argnames=("params", "n_steps", "method",
                                    "record_every"))
def _rollout_scan(state, params, n_steps, method, record_every):
    fn = _METHODS[method]
    n_outer = n_steps // record_every

    def outer(s, _):
        s = jax.lax.scan(lambda t, __: (fn(t, params), None),
                         s, None, length=record_every)[0]
        return s, s.pos

    return jax.lax.scan(outer, state, None, length=n_outer)


class FluidSim:
    """Convenience OO facade mirroring the reference ParticleSystem API
    (init/step/getPositions — SURVEY.md §1 L1), wrapping the functional core.

    ``method='native'`` selects the multithreaded C++ CPU engine
    (csrc/fluidcore via oracle/native.py) — the analog of the reference's
    GPU-vs-CPU mode switch (SURVEY.md §3.4).  It steps on the host rather
    than under lax.scan, so it lives here in the facade, not the jax
    method registry.
    """

    def __init__(self, params: SimParams, state: State,
                 method: str = "auto"):
        self.params = params
        self.state = state
        if method == "native":
            from ..oracle import native
            if not native.available():
                raise RuntimeError(
                    "native fluidcore engine unavailable "
                    "(`make -C csrc` needs a working g++)")
            self.method = "native"
        else:
            self.method = resolve_method(method, state.n)
        # keep the raw request: run() upgrades 'auto' rollouts at scale to
        # the incremental pipeline (an explicit method is honored verbatim)
        self._requested = method

    def step(self, n: int = 1) -> State:
        if self.method == "native":
            return self._step_native(n)
        self.state = run(self.state, self.params, n, self._requested)
        return self.state

    def _step_native(self, n: int) -> State:
        import numpy as np
        from ..oracle import native
        pos, vel, rho, pres = native.run(
            np.asarray(self.state.pos, np.float64),
            np.asarray(self.state.vel, np.float64),
            self.params, n)
        self.state = State(
            pos=jnp.asarray(pos, jnp.float32),
            vel=jnp.asarray(vel, jnp.float32),
            rho=jnp.asarray(rho, jnp.float32),
            pres=jnp.asarray(pres, jnp.float32),
            ids=self.state.ids,
            overflow=jnp.zeros((), jnp.int32))
        return self.state

    def get_positions(self):
        """Positions in original (spawn) particle order — mirrors the
        reference's getPositions() even though the device order is sorted."""
        import numpy as np
        return self._unsort(self.state.pos)

    def get_velocities(self):
        import numpy as np
        return self._unsort(self.state.vel)

    def _unsort(self, arr):
        import numpy as np
        arr = np.asarray(arr)
        ids = np.asarray(self.state.ids)
        out = np.empty_like(arr)
        out[ids] = arr
        return out
