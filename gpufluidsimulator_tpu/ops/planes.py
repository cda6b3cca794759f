"""Rank-planar cell-grid layout for the neighbour sweeps.

Reference counterpart: the sort + ``reorderDataAndFindCellStartKernel`` data
staging of the CUDA path (SURVEY.md §2/§3.1): particles sorted by cell so a
cell's particles are adjacent, with a fixed capacity of K slots per cell in
place of the ``cellStart``/``cellEnd`` ranges:

  * Each field (pos x/y/z, vel) is a **rank plane**: a (K, pz, n_bx, py, 128)
    f32 array.  plane[k, z, xo, y, xi] = field value of the rank-k particle
    of cell (z, y, x = xo*126 + xi - 1), or a sentinel when the slot is
    empty.
  * x is split into tiles of 126 interior cells + 2 halo lanes; lane 0/127
    of each tile mirror the adjacent tile's edge cells via two static slice
    copies (``halo_x`` — the same exchange pattern the multi-device path
    uses with ppermute).  A neighbour cell is then a fixed offset in the
    flattened plane: +-1 in x, +-128 in y, +-n_bx*py*128 in z.
  * Ghost cells: 1 plane in z, an 8-row band in y, lane 0 of the first tile
    and the trailing lanes of the last, so stencil reads of interior cells
    never leave the array and need no masks.

The particle state is kept **cell-sorted** across steps (the reference's
reorder trick adopted as the canonical order); identity travels in ``ids``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.params import SimParams

SENTINEL = 1.0e6
LANES = 128
TILE_X = LANES - 2          # interior cells per x tile
ROWS_PER_BLOCK = 8          # y ghost band; interior rows come in blocks


class PlaneGeom(NamedTuple):
    """Static geometry of the plane layout (all Python ints)."""
    dim: int
    k: int                   # cell capacity (rank count)
    nx: int                  # interior cells in x
    ny: int
    nz: int                  # 1 for 2D
    n_bx: int                # x tiles
    py: int                  # allocated y cells (ghost band 8 + interior + pad)
    pz: int                  # allocated z planes (1 ghost each side; 1 if 2D)
    n_by: int                # interior y blocks
    cells: int               # total cells = pz * n_bx * py * 128


def geometry(params: SimParams) -> PlaneGeom:
    if params.x_halfwidth != 1:
        raise ValueError(
            "the rank-plane (pallas) tier needs every binning cell >= h "
            "(x-stencil halfwidth 1); anisotropic finer-x cells are "
            "supported by the gridded tier only (docs/ARCHITECTURE.md: "
            "their alias-free occupancy does not survive evolved flow).")
    res = params.grid_res
    nx = res[0]
    ny = res[1]
    nz = res[2] if params.dim == 3 else 1
    n_bx = -(-nx // TILE_X)
    n_by = -(-(ny + 2) // ROWS_PER_BLOCK)        # interior + 1-cell halo
    py = (1 + n_by + 1) * ROWS_PER_BLOCK         # one ghost block each side
    pz = nz + 2 if params.dim == 3 else 1
    return PlaneGeom(dim=params.dim, k=params.cell_capacity,
                     nx=nx, ny=ny, nz=nz, n_bx=n_bx, py=py, pz=pz,
                     n_by=n_by, cells=pz * n_bx * py * LANES)


def snap_cell(params: SimParams, max_stretch: float = 1.06,
              min_gain: float = 0.85) -> SimParams:
    """Pick a binning cell (>= h) that avoids pathological slot-space padding.

    The plane layout quantizes hard: x in 126-lane tiles, y in 8-row blocks,
    z per plane.  A grid whose x-extent lands *just* past a tile boundary
    allocates a whole extra x tile that is ~95% padding (grid 132^3 costs
    2.27x the slot space of the grid below the boundary).  Since the
    binning cell only has
    to satisfy ``cell >= h`` for the 3^d stencil to cover the interaction
    radius, stretching it slightly can fold the grid back under the boundary.

    Tries every integer cells-per-axis target within ``max_stretch`` of the
    h-derived resolution and keeps the smallest stretch that shrinks the
    allocated slot space to <= ``min_gain`` of the unsnapped layout (the
    threshold avoids trading sweep-occupancy growth for marginal savings).
    No-op when ``cell_size`` was set explicitly.
    """
    if params.cell_size > 0.0 or params.cell_aniso:
        return params
    base = params.h
    base_cells = geometry(params).cells
    cands = set()
    for d in range(params.dim):
        extent = params.bounds_max[d] - params.bounds_min[d]
        n = max(1, int(math.ceil(extent / base - 1e-9)))
        n_lo = max(1, int(math.floor(n / max_stretch)))
        for n2 in range(n_lo, n):
            c = extent / n2
            if base < c <= base * max_stretch:
                cands.add(c)
    best = None
    for c in sorted(cands):
        cells = geometry(params.replace(cell_size=c)).cells
        if cells <= min_gain * base_cells and (
                best is None or cells < best[1]):
            best = (c, cells)
    if best is None:
        return params
    return params.replace(cell_size=best[0])


def lattice_dx(params: SimParams) -> float:
    """Recover the scene's lattice spacing from the particle mass
    (scenes._derive sets mass = rho0 * dx^dim)."""
    return (params.particle_mass / params.rest_density) ** (1.0 / params.dim)


def cell_linear_parts(pos, params: SimParams, geom: PlaneGeom,
                      x_origin=None):
    """(N, d) -> (N,) linear cell index in the allocated plane frame.

    ``x_origin`` (traced scalar) overrides bounds_min[0] — the sharded path
    passes each device's domain offset while sharing one compiled program.
    """
    lo = jnp.asarray(params.bounds_min, pos.dtype)
    cax = params.cells_axis

    def axis(d, n, origin=None):
        base = lo[d] if origin is None else origin
        c = jnp.floor((pos[:, d] - base) * (1.0 / cax[d])).astype(jnp.int32)
        return jnp.clip(c, 0, n - 1)

    x = axis(0, geom.nx, x_origin)
    xo = x // TILE_X
    xi = x % TILE_X + 1                              # lane 0 = halo/ghost
    y = axis(1, geom.ny) + ROWS_PER_BLOCK            # ghost block below
    z = (axis(2, geom.nz) + 1 if params.dim == 3
         else jnp.zeros_like(x))
    return ((z * geom.n_bx + xo) * geom.py + y) * LANES + xi


def halo_x(arr):
    """Mirror x-tile edge cells into the neighbor tiles' halo lanes.

    arr: (..., n_bx, py, 128).  lane 0 of tile t+1 <- lane 126 of tile t;
    lane 127 of tile t <- lane 1 of tile t+1.  No-op when n_bx == 1 (the
    outermost lanes then stay ghost).  This is the intra-chip version of the
    ppermute ghost exchange used across chips (SURVEY.md §5.8).
    """
    if arr.shape[-3] == 1:
        return arr
    arr = arr.at[..., 1:, :, 0].set(arr[..., :-1, :, TILE_X])
    arr = arr.at[..., :-1, :, LANES - 1].set(arr[..., 1:, :, 1])
    return arr


class PlaneTable(NamedTuple):
    """Binned particle data in rank-planar layout.

    Particle arrays come back **cell-sorted**: the caller adopts the sorted
    order as the new canonical particle order and carries identity in
    ``ids``.
    """
    planes: jnp.ndarray       # (F, K, pz, n_bx, py, 128) f32 (see FIELD_*)
    slot: jnp.ndarray         # (N,) int32 flat slot k*cells + cell of the
                              #   SORTED particle i; k*cells when dropped
    ok: jnp.ndarray           # (N,) bool: sorted particle landed in a slot
    pos_s: jnp.ndarray        # (N, d) cell-sorted positions
    vel_s: jnp.ndarray        # (N, d) cell-sorted velocities
    ids_s: jnp.ndarray        # (N,)   cell-sorted particle identities
    overflow: jnp.ndarray     # ()  int32


# field indices within `planes`
FIELD_X, FIELD_Y, FIELD_Z = 0, 1, 2
FIELD_VX, FIELD_VY, FIELD_VZ = 3, 4, 5
N_POS_FIELDS = 3


def build_planes(pos, vel, ids, params: SimParams, geom: PlaneGeom,
                 x_origin=None, active=None, with_ids=False) -> PlaneTable:
    """Bin particles into rank planes (sort_by_key + reorder analog).

    ``active`` (N,) bool marks live particles; inactive rows (the sharded
    path's free-capacity slots) sort to the end, bind to no cell, and are
    excluded from the overflow count.  ``with_ids`` adds the particle id as
    a 7th f32 plane channel (-1 on empty slots; the incremental path
    carries identity in the planes themselves, while empty slots are
    identified by the x-channel sentinel).
    """
    n = pos.shape[0]
    k = geom.k
    cells = geom.cells

    cid = cell_linear_parts(pos, params, geom, x_origin)
    if active is not None:
        cid = jnp.where(active, cid, cells)     # one-past-the-end "cell"
    # one multi-operand sort by cell id carries every field along with the
    # key.  Unstable: rank order within a cell is physically arbitrary.
    dim = params.dim
    operands = (cid,) + tuple(pos[:, j] for j in range(dim)) \
        + tuple(vel[:, j] for j in range(dim)) + (ids,)
    out = jax.lax.sort(operands, num_keys=1, is_stable=False)
    cid_sorted = out[0]
    # rank within cell: position minus the index where this cell's run began
    idx = jnp.arange(n, dtype=jnp.int32)
    run_start = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.where(cid_sorted[1:] != cid_sorted[:-1], idx[1:], 0)])
    rank = idx - jax.lax.cummax(run_start)
    in_domain = cid_sorted < cells
    ok = (rank < k) & in_domain
    overflow = jnp.sum(~ok & in_domain).astype(jnp.int32)
    slot = jnp.where(ok, rank * cells + cid_sorted, k * cells)

    pos_cols = list(out[1:1 + dim])
    vel_cols = list(out[1 + dim:1 + 2 * dim])
    ids_s = out[-1]
    zero = jnp.zeros_like(pos_cols[0])
    # channel values and empty-slot fills; 2D keeps all-zero z channels
    cols = pos_cols + [zero] * (3 - dim) + vel_cols + [zero] * (3 - dim)
    fills = [SENTINEL] * dim + [0.0] * (3 - dim) + [0.0] * 3
    if with_ids:
        cols.append(ids_s.astype(jnp.float32))
        fills.append(-1.0)
    # placement is one scatter: slots are unique, dropped rows fall off
    # the end (mode="drop")
    base = jnp.broadcast_to(jnp.asarray(fills, jnp.float32)[:, None],
                            (len(cols), k * cells))
    planes = base.at[:, slot].set(jnp.stack(cols), mode="drop")
    planes = halo_x(planes.reshape(
        (len(cols), k, geom.pz, geom.n_bx, geom.py, LANES)))
    return PlaneTable(planes=planes, slot=slot, ok=ok,
                      pos_s=jnp.stack(pos_cols, axis=-1),
                      vel_s=jnp.stack(vel_cols, axis=-1), ids_s=ids_s,
                      overflow=overflow)


def occupancy_bounds(planes, params: SimParams, geom: PlaneGeom,
                     rows: int = ROWS_PER_BLOCK):
    """Per query block (``rows`` y rows x 128 lanes of one z plane) bounds
    on the occupied ranks: occ_q (nzq, n_bx, nyq) for the block itself and
    occ_s (nzq, n_bx, nyq, n_dz) for its y-widened slab at each z offset,
    so a rank loop bounded by them visits every occupied slot.  Taken from
    the (already halo'd) positions."""
    assert ROWS_PER_BLOCK % rows == 0, rows
    valid = planes[FIELD_X] < SENTINEL * 0.5
    rowmax = jnp.max(jnp.sum(valid, axis=0, dtype=jnp.int32), axis=-1)
    y0 = ROWS_PER_BLOCK
    nyq = geom.n_by * ROWS_PER_BLOCK // rows
    y1 = y0 + nyq * rows
    blk = jnp.max(rowmax[..., y0:y1].reshape(
        rowmax.shape[:-1] + (nyq, rows)), axis=-1)
    below = rowmax[..., y0 - 1:y1 - 1:rows]
    above = rowmax[..., y0 + rows:y1 + rows:rows]
    slab = jnp.maximum(blk, jnp.maximum(below, above))
    if params.dim == 3:
        nz = geom.nz
        occ_q = blk[1:nz + 1]
        occ_s = jnp.stack([slab[0:nz], slab[1:nz + 1], slab[2:nz + 2]],
                          axis=-1)
    else:
        occ_q, occ_s = blk, slab[..., None]
    return occ_q, occ_s


def gather_slots(plane_stack, slot, ok, fill):
    """(F, K, pz, n_bx, py, 128) planes + (N,) slots -> (N, F) per-particle
    values in sorted order.  Dropped particles (ok == False) get `fill`."""
    f = plane_stack.shape[0]
    flat = plane_stack.reshape(f, -1)
    idx = jnp.minimum(slot, flat.shape[1] - 1)
    return jnp.where(ok[:, None], flat[:, idx].T, fill)
