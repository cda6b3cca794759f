"""Gridded SPH density/forces in pure XLA (config 2: 65k, single device).

Reference counterparts: ``computeDensityPressureKernel`` and
``computeForcesKernel`` — the two hot 27-cell neighbor-sweep kernels
(SURVEY.md §3.1).

Design: all work happens in the *dense cell-table layout*
``(C, K, ...)`` built by ops/grid.py.  The 3^d neighbor stencil becomes 3^d
static *linear cell offsets*; "visit neighbor cell" is a static slice of a
once-padded dense array — no wraparound and no data-dependent control flow.
Each stencil offset contributes a fully vectorised (C, K, K) pair block that
XLA fuses into the accumulation, so nothing of size (C, K, 3^d K) is ever
materialised.  Pair distances use direct coordinate differences, the same
numerical policy as the rank-plane sweeps (the |a|^2+|b|^2-2ab expansion
loses ~3 digits near r->0 and is not used anywhere — see ops/pallas_sph.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.params import SimParams
from . import grid as gridmod
from . import kernels, physics
from .grid import CellTable


def _shift_views(dense, offsets, pad_value):
    """Build {off: view} where view[c] == dense[c + off] for interior cells.

    One pad along the cell axis, then 3^d static slices (XLA views — cheap,
    fusion-friendly, no roll copies).
    """
    m = max(abs(o) for o in offsets)
    c = dense.shape[0]
    pad_width = [(m, m)] + [(0, 0)] * (dense.ndim - 1)
    padded = jnp.pad(dense, pad_width, constant_values=pad_value)
    return {off: jax.lax.slice_in_dim(padded, m + off, m + off + c, axis=0)
            for off in offsets}


def density_dense(table: CellTable, params: SimParams):
    """Per-slot density (C, K) over the 3^d stencil."""
    offs = gridmod.neighbor_offsets(params)
    pos_views = _shift_views(table.pos, offs, gridmod.SENTINEL)
    rho = jnp.zeros(table.pos.shape[:2], jnp.float32)
    for off in offs:
        diff = table.pos[:, :, None, :] - pos_views[off][:, None, :, :]
        r2 = jnp.sum(diff * diff, axis=-1)              # (C, K, K)
        w = kernels.poly6(r2, params.h, params.dim)
        rho = rho + jnp.sum(w, axis=-1)
    return params.particle_mass * rho


def accel_dense(table: CellTable, rho, pres, params: SimParams):
    """Per-slot acceleration (C, K, d): symmetric-form pressure gradient +
    viscosity + gravity (same physics as ops/naive.py)."""
    m = params.particle_mass
    h = params.h
    p_r2 = pres / (rho * rho)                           # (C, K)
    inv_rho = 1.0 / rho

    offs = gridmod.neighbor_offsets(params)
    pos_views = _shift_views(table.pos, offs, gridmod.SENTINEL)
    vel_views = _shift_views(table.vel, offs, 0.0)
    pr2_views = _shift_views(p_r2, offs, 0.0)
    irho_views = _shift_views(inv_rho, offs, 1.0)

    acc = jnp.zeros_like(table.pos)
    for off in offs:
        pos_n = pos_views[off]
        diff = table.pos[:, :, None, :] - pos_n[:, None, :, :]
        r2 = jnp.sum(diff * diff, axis=-1)
        r = jnp.sqrt(jnp.maximum(r2, 1e-24))
        valid = (r2 < h * h) & (r2 > 1e-16)

        g = kernels.spiky_grad_mag(r, h, params.dim)
        coef_p = jnp.where(
            valid,
            -m * (p_r2[:, :, None] + pr2_views[off][:, None, :]) * g / r,
            0.0)
        acc = acc + jnp.sum(coef_p[..., None] * diff, axis=2)

        lap = kernels.visc_lap(r, h, params.dim)
        coef_v = jnp.where(
            valid,
            params.viscosity * m
            * inv_rho[:, :, None] * irho_views[off][:, None, :] * lap,
            0.0)
        dvel = vel_views[off][:, None, :, :] - table.vel[:, :, None, :]
        acc = acc + jnp.sum(coef_v[..., None] * dvel, axis=2)

    grav = jnp.asarray(params.gravity, jnp.float32)
    return acc + grav


def step_gridded(pos, vel, params: SimParams):
    """One full gridded SPH step. Returns (pos, vel, rho, pres, overflow)."""
    table = gridmod.build_cell_table(pos, vel, params)

    rho_d = density_dense(table, params)
    # empty slots would divide by ~0 downstream; give them rest density
    rho_d = jnp.where(table.valid, rho_d, params.rest_density)
    pres_d = physics.eos_pressure(rho_d, params)
    acc_d = accel_dense(table, rho_d, pres_d, params)

    # back to original particle order; dropped particles free-fall (documented
    # overflow policy — shipped scenes assert overflow == 0)
    grav = jnp.asarray(params.gravity, jnp.float32)
    acc = gridmod.gather_per_particle(acc_d, table.slot, 0.0)
    acc = jnp.where((table.slot >= 0)[:, None], acc, grav)
    rho = gridmod.gather_per_particle(rho_d[..., None], table.slot,
                                      params.rest_density)[..., 0]
    pres = gridmod.gather_per_particle(pres_d[..., None], table.slot,
                                       0.0)[..., 0]

    pos, vel = physics.integrate(pos, vel, acc, params)
    return pos, vel, rho, pres, table.overflow
