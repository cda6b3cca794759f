"""Particle state pytree.

Reference counterpart: the device buffers owned by the ``ParticleSystem`` host
class (pos/vel/density/pressure, SURVEY.md §1 L1).  Here: a pure
functional NamedTuple pytree — no mutation, no host class; ``step`` maps
State -> State under jit, and the whole trajectory lives in one ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class State(NamedTuple):
    pos: jnp.ndarray        # (N, dim) float32
    vel: jnp.ndarray        # (N, dim) float32
    rho: jnp.ndarray        # (N,)     float32  (diagnostic: last-step density)
    pres: jnp.ndarray       # (N,)     float32  (diagnostic: last-step pressure)
    # Particle identity.  The pallas path keeps particles cell-sorted (the
    # reference's reorder trick, adopted as the canonical order to avoid
    # scatter-backs); `ids` tracks each row back to its spawn index.
    ids: jnp.ndarray
    # cell-capacity overflow count from the last gridded step (SURVEY.md §4.2:
    # "fixed-capacity overflow counter is observable"); 0 for the naive path.
    # (No jnp defaults here: NamedTuple defaults evaluate at import time and
    # would initialize the XLA backend before jax.distributed.initialize —
    # see parallel.mesh.init_distributed / tests/test_multihost.py.)
    overflow: jnp.ndarray

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]


def make_state(pos, vel=None) -> State:
    pos = jnp.asarray(pos, jnp.float32)
    if vel is None:
        vel = jnp.zeros_like(pos)
    else:
        vel = jnp.asarray(vel, jnp.float32)
    n = pos.shape[0]
    return State(pos=pos, vel=vel,
                 rho=jnp.zeros((n,), jnp.float32),
                 pres=jnp.zeros((n,), jnp.float32),
                 ids=jnp.arange(n, dtype=jnp.int32),
                 overflow=jnp.zeros((), jnp.int32))
