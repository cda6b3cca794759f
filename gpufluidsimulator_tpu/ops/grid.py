"""Uniform-grid neighbor structure: hashing + fixed-capacity cell table.

Reference counterparts: ``calcHashKernel`` (position -> linearized cell id),
``thrust::sort_by_key`` particle binning, and
``reorderDataAndFindCellStartKernel`` (SURVEY.md §2, §3.1).

Design: instead of variable-length cellStart/cellEnd ranges, a
**fixed-capacity dense cell table** of shape
``(num_cells, K, ...)``:

  1. cell id per particle  (vectorised floor-divide + ravel)
  2. stable ``argsort`` by cell id (the device-side sort_by_key analog;
     O(N log N) on device, no host sync)
  3. rank-within-cell from a searchsorted against the sorted keys
  4. scatter particles into their ``(cell, rank)`` slot; rank >= K overflows
     are counted and dropped deterministically (observable via ``overflow``)

The grid is padded with one ring of ghost cells per axis so the 3^d neighbor
offsets of any *interior* cell are always valid linear offsets — no edge
branches in the hot loops (branch-free XLA/Pallas control flow).

Empty slots hold a far-away sentinel position so smoothing kernels evaluate
to exactly 0 against them — masking is free.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..models.params import SimParams

# Sentinel position for empty slots: far enough that any pair distance is
# outside every kernel support, small enough that r^2 stays finite in f32.
SENTINEL = 1.0e6


def halfwidths(params: SimParams) -> Tuple[int, ...]:
    """Per-axis stencil halfwidth: 1 for cells >= h; ceil(h/cell) on a
    finer axis (anisotropic cells, SimParams.cell_aniso)."""
    import math
    return tuple(max(1, int(math.ceil(params.h / c - 1e-6)))
                 for c in params.cells_axis)


def padded_res(params: SimParams) -> Tuple[int, ...]:
    return tuple(r + 2 * hw
                 for r, hw in zip(params.grid_res, halfwidths(params)))


def num_padded_cells(params: SimParams) -> int:
    n = 1
    for r in padded_res(params):
        n *= r
    return n


def strides(params: SimParams) -> Tuple[int, ...]:
    """Linearisation strides, axis 0 fastest (x-major), for padded grid."""
    pr = padded_res(params)
    s = [1]
    for r in pr[:-1]:
        s.append(s[-1] * r)
    return tuple(s)


def neighbor_offsets(params: SimParams) -> Tuple[int, ...]:
    """The linear cell offsets of the neighborhood stencil (3^d for cubic
    cells; a finer axis widens to 2*hw+1 offsets along it)."""
    st = strides(params)
    hws = halfwidths(params)
    offs = [0]
    for d in range(params.dim):
        offs = [o + dd * st[d] for o in offs
                for dd in range(-hws[d], hws[d] + 1)]
    return tuple(sorted(offs))


def cell_id(pos, params: SimParams):
    """(N, d) positions -> (N,) linearized *padded* cell ids (interior)."""
    lo = jnp.asarray(params.bounds_min, pos.dtype)
    cax = params.cells_axis
    hws = halfwidths(params)
    res = params.grid_res
    st = strides(params)
    cid = jnp.zeros(pos.shape[:-1], jnp.int32)
    for d in range(params.dim):
        c = jnp.floor((pos[..., d] - lo[d]) * (1.0 / cax[d])).astype(
            jnp.int32)
        c = jnp.clip(c, 0, res[d] - 1) + hws[d]   # ghost ring offset
        cid = cid + c * st[d]
    return cid


class CellTable(NamedTuple):
    """Dense fixed-capacity cell table (the reorderDataAndFindCellStart
    analog).  C = num_padded_cells, K = cell_capacity."""

    pos: jnp.ndarray          # (C, K, d) — SENTINEL where empty
    vel: jnp.ndarray          # (C, K, d) — 0 where empty
    slot: jnp.ndarray         # (N,) linear slot index into C*K; -1 if dropped
    valid: jnp.ndarray        # (C, K) bool
    overflow: jnp.ndarray     # () int32 — dropped (rank >= K) particle count


def build_cell_table(pos, vel, params: SimParams) -> CellTable:
    n = pos.shape[0]
    k = params.cell_capacity
    c = num_padded_cells(params)

    cid = cell_id(pos, params)
    order = jnp.argsort(cid, stable=True)               # sort_by_key analog
    cid_sorted = cid[order]
    first = jnp.searchsorted(cid_sorted, cid_sorted, side="left")
    rank = jnp.arange(n, dtype=jnp.int32) - first.astype(jnp.int32)
    ok = rank < k
    overflow = jnp.sum(~ok).astype(jnp.int32)

    slot_sorted = jnp.where(ok, cid_sorted * k + rank, c * k)  # c*k = dropped
    flat_pos = jnp.full((c * k, pos.shape[1]), SENTINEL, pos.dtype)
    flat_pos = flat_pos.at[slot_sorted].set(pos[order], mode="drop")
    flat_vel = jnp.zeros((c * k, vel.shape[1]), vel.dtype)
    flat_vel = flat_vel.at[slot_sorted].set(vel[order], mode="drop")
    valid = jnp.zeros((c * k,), jnp.bool_).at[slot_sorted].set(
        True, mode="drop")

    # per-original-particle slot: scatter sorted slots back through `order`
    slot = jnp.full((n,), -1, jnp.int32).at[order].set(
        jnp.where(ok, slot_sorted, -1).astype(jnp.int32))

    return CellTable(
        pos=flat_pos.reshape(c, k, pos.shape[1]),
        vel=flat_vel.reshape(c, k, vel.shape[1]),
        slot=slot,
        valid=valid.reshape(c, k),
        overflow=overflow,
    )


def gather_per_particle(dense_field, slot, fill):
    """(C, K, ...) dense per-slot results -> (N, ...) per original particle.

    Dropped particles (slot == -1) receive ``fill``.
    """
    flat = dense_field.reshape((-1,) + dense_field.shape[2:])
    out = flat[jnp.clip(slot, 0)]
    return jnp.where(
        (slot >= 0).reshape((-1,) + (1,) * (out.ndim - 1)), out, fill)
