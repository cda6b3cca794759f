"""Incremental binning: the rank-planar grid as persistent canonical state.

Reference counterpart: none — the CUDA reference re-sorts every frame
(SURVEY.md §3.1).  Under CFL time steps only 0.2-2.3% of particles change
cell per step (scripts/mover_stats.py, docs/ARCHITECTURE.md), so the full
sort of ``planes.build_planes`` is replaced by mover-only work:

  * the plane stack (6 pos/vel channels + 1 id channel) IS the state carried
    across steps; flat particle arrays exist only at the API boundary;
  * the force sweep integrates in place and flags the slots whose particle
    left its cell (ops/pallas_sph ``emit_movers``);
  * the flagged slots are gathered into compact mover rows, the kept slots
    of every cell are compacted down to dense ranks, and the movers — sorted
    by target cell — are scattered onto the first free ranks of their new
    cells.

Layout invariants (ops/planes.py): x halo lanes and y/z ghost regions are
refreshed or ignored each step; empty slots hold SENTINEL positions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.params import SimParams
from . import planes as pm
from .planes import LANES, TILE_X, ROWS_PER_BLOCK, PlaneGeom, SENTINEL

RESUM_EVERY = 64       # continuity tier, cont_form="rate" only: steps
# between summation-density re-syncs.  The rate form integrates
# drho/dt = sum m (vi-vj).gradW explicitly, which drifts
# O(dt * div-v error) per step from the summation density the EOS was
# calibrated against; a full poly6 re-summation every RESUM_EVERY steps
# pins the drift.  The sum and relax forms re-anchor at the in-sweep
# summation every step, so they only sum once, at age 0, to seed the EOS
# before the first sweep has run.


def mover_capacity(n: int) -> int:
    """Static mover-array capacity: N/8 (at least 1024), a multiple of 128.
    Mover fractions stay <= 2.3% per step (docs/ARCHITECTURE.md); excess
    movers are dropped and counted in ``overflow``."""
    return -(-max(1024, n // 8) // LANES) * LANES


class IncState(NamedTuple):
    """Scan-carried state of the incremental path."""
    fields6: jnp.ndarray     # (6, K, pz, n_bx, py, 128) x,y,z,vx,vy,vz
    idp: jnp.ndarray         # (K, pz, n_bx, py, 128) particle id as f32
    overflow: jnp.ndarray    # () i32, physics-capacity drops (mover stage,
    #                          arrival ranks, cell ranks)
    mig_overflow: jnp.ndarray  # () i32, mover-buffer capacity misses
    #                          (sharded-inc only; 0 on one device) —
    #                          kept separate from ``overflow`` so cell
    #                          overflow and migration capacity misses stay
    #                          independently observable, mirroring
    #                          parallel.sharded.run_sharded
    rhop: jnp.ndarray = None   # continuity tier only: carried density
    #                          plane (K, pz, n_bx, py, 128); None on the
    #                          summation-density path
    age: jnp.ndarray = None    # continuity tier only: () i32 step counter
    #                          driving the RESUM_EVERY re-summation cadence

    @property
    def geom_shape(self):
        return self.fields6.shape[1:]


# ---------------------------------------------------------------------------
# static slot geometry
# ---------------------------------------------------------------------------

def own_cid(geom: PlaneGeom) -> jnp.ndarray:
    """(pz, n_bx, py, 128) i32: the linear cell id of each plane column (the
    same linearization as planes.cell_linear_parts)."""
    shape = (geom.pz, geom.n_bx, geom.py, LANES)
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    xo = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    y = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    xi = jax.lax.broadcasted_iota(jnp.int32, shape, 3)
    return ((z * geom.n_bx + xo) * geom.py + y) * LANES + xi


def interior_mask(geom: PlaneGeom) -> jnp.ndarray:
    """(pz, n_bx, py, 128) bool: True for real (owning) cells — excludes x
    halo lanes, the x tail of the last tile, y ghost bands and z ghost
    planes.  Slots outside this mask are never particle owners."""
    shape = (geom.pz, geom.n_bx, geom.py, LANES)
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    xo = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    y = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    xi = jax.lax.broadcasted_iota(jnp.int32, shape, 3)
    gx = xo * TILE_X + xi - 1
    ok = (xi >= 1) & (xi <= TILE_X) & (gx < geom.nx)
    ok &= (y >= ROWS_PER_BLOCK) & (y < ROWS_PER_BLOCK + geom.ny)
    if geom.dim == 3:
        ok &= (z >= 1) & (z <= geom.nz)
    return ok


def new_cids(fields6, params: SimParams, geom: PlaneGeom, x_origin=None):
    """Per-slot linear cell id from the position channels (elementwise
    mirror of planes.cell_linear_parts)."""
    lo = params.bounds_min
    cax = params.cells_axis

    def axis(d, n, origin=None):
        base = lo[d] if origin is None else origin
        c = jnp.floor((fields6[d] - base) * (1.0 / cax[d])).astype(jnp.int32)
        return jnp.clip(c, 0, n - 1)

    x = axis(0, geom.nx, x_origin)
    xo = x // TILE_X
    xi = x % TILE_X + 1
    y = axis(1, geom.ny) + ROWS_PER_BLOCK
    if geom.dim == 3:
        z = axis(2, geom.nz) + 1
    else:
        z = jnp.zeros_like(x)
    return ((z * geom.n_bx + xo) * geom.py + y) * LANES + xi


def detect_movers(fields6, idp, params: SimParams, geom: PlaneGeom,
                  x_origin=None):
    """-> (kept6, kept_id, flags).  ``flags`` (K, pz, n_bx, py, 128) marks
    interior slots whose particle now belongs to a different cell; kept
    planes have those slots (and every non-interior slot) blanked."""
    valid = (fields6[0] < SENTINEL * 0.5) & interior_mask(geom)[None]
    cid = new_cids(fields6, params, geom, x_origin)
    flags = valid & (cid != own_cid(geom)[None])
    keep = valid & ~flags
    kept6 = jnp.where(keep[None], fields6,
                      jnp.where(jnp.arange(6)[:, None, None, None, None, None]
                                < 3, SENTINEL, 0.0))
    kept_id = jnp.where(keep, idp, -1.0)
    return kept6, kept_id, flags


# ---------------------------------------------------------------------------
# flagged compaction and re-insertion
# ---------------------------------------------------------------------------

def compact_flagged(channels, flags, max_out: int):
    """Gather the flagged slots' channel values into compact rows.

    channels: list of f32 arrays — each either a single channel (shape ==
    flags.shape) or a group (leading dim = channel count, rest ==
    flags.shape).  flags: bool array.  Returns (vals (C, max_out), count)
    with the flagged slots in slot order; slots beyond ``max_out`` are
    dropped (the caller counts them) and unused columns are 0.
    """
    flat = flags.reshape(-1)
    # each flagged slot's output column is its exclusive flag count; one
    # scatter of slot indices (the rest drop off the end) then says which
    # slot feeds each column
    col = jnp.cumsum(flat, dtype=jnp.int32)
    total = col[-1]
    col = jnp.where(flat, col - 1, max_out)
    idx = jnp.zeros((max_out,), jnp.int32).at[col].set(
        jnp.arange(flat.shape[0], dtype=jnp.int32), mode="drop")
    got = jnp.arange(max_out) < total
    # one 1D gather per channel (a gather across the stacked channel axis
    # makes XLA transpose the whole stack first)
    rows = [r for c in channels for r in c.reshape(-1, flat.shape[0])]
    vals = jnp.stack([jnp.where(got, r[idx], 0.0) for r in rows])
    return vals, jnp.minimum(total, max_out)


def _fills(nf: int):
    """Empty-slot values of the (x,y,z,vx,vy,vz,id[,rho]) channels."""
    return [SENTINEL] * 3 + [0.0] * 3 + [-1.0] + [0.0] * (nf - 7)


def consolidate(new6, idp, flagp, movers, live, params: SimParams,
                geom: PlaneGeom, x_origin=None, rhop=None):
    """Rebuild dense per-cell ranks from the kept slots plus the movers.

    Kept slots (interior, valid, not flagged as movers) move down to ranks
    0..n_kept-1 of their cell in rank order (a gather along the rank axis);
    the live movers (``movers`` (nf, M) rows x,y,z,vx,vy,vz,id[,rho],
    ``live`` (M,) mask) are sorted by target cell and scattered onto ranks
    n_kept, n_kept+1, ...  A mover that would land past rank K is dropped
    and counted — exactly the full rebuild's overflow rule.  Non-interior
    slots (ghosts, halo lanes) come out empty.

    Returns (fields6, idp, n_dropped), or (fields6, idp, rho, n_dropped)
    when the continuity tier's carried density plane ``rhop`` is given
    (then movers carry rho as channel 7).
    """
    k, cells = geom.k, geom.cells
    chans = [new6[i] for i in range(6)] + [idp]
    if rhop is not None:
        chans.append(rhop)
    nf = len(chans)
    assert movers.shape[0] == nf, (movers.shape, nf)
    keep = ((new6[0] < SENTINEL * 0.5) & interior_mask(geom)[None]
            & (flagp < 0.5))
    cnt = jnp.cumsum(keep, axis=0, dtype=jnp.int32)       # inclusive
    n_kept = cnt[-1]
    # output rank r takes the source rank where the running count reaches
    # r + 1, i.e. the number of ranks whose count is still <= r; the
    # kept values then come through one flat 1D gather per channel
    r = jnp.arange(k, dtype=jnp.int32).reshape((k,) + (1,) * n_kept.ndim)
    src = jnp.minimum(jnp.sum(cnt[None] <= r[:, None], axis=1,
                              dtype=jnp.int32), k - 1)
    cell = jnp.arange(cells, dtype=jnp.int32).reshape(n_kept.shape)
    src = (src * cells + cell).reshape(-1)
    has = (r < n_kept).reshape(-1)

    # movers: sort by target cell, rank within the run, land after the kept
    dim = params.dim
    pos = jnp.stack([movers[d] for d in range(dim)], axis=-1)
    cid = jnp.where(live, pm.cell_linear_parts(pos, params, geom, x_origin),
                    cells)
    out = jax.lax.sort((cid,) + tuple(movers[i] for i in range(nf)),
                       num_keys=1, is_stable=False)
    cid_s = out[0]
    jdx = jnp.arange(cid_s.shape[0], dtype=jnp.int32)
    run_start = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.where(cid_s[1:] != cid_s[:-1], jdx[1:], 0)])
    dup = jdx - jax.lax.cummax(run_start)
    real = cid_s < cells
    rank = n_kept.reshape(-1)[jnp.minimum(cid_s, cells - 1)] + dup
    ok = real & (rank < k)
    dest = jnp.where(ok, rank * cells + cid_s, k * cells)
    res = []
    for x, fill, mv in zip(chans, _fills(nf), out[1:]):
        v = jnp.where(has, x.reshape(-1)[src], fill)
        res.append(v.at[dest].set(mv, mode="drop").reshape(x.shape))
    n_dropped = jnp.sum(real & ~ok).astype(jnp.int32)
    fields6 = jnp.stack(res[:6])
    if rhop is not None:
        return fields6, res[6], res[7], n_dropped
    return fields6, res[6], n_dropped


# ---------------------------------------------------------------------------
# API-boundary conversions
# ---------------------------------------------------------------------------

def to_planes(pos, vel, ids, params: SimParams, geom: PlaneGeom,
              x_origin=None, active=None,
              continuity: bool = False) -> IncState:
    """Full rebuild (the build_planes path) producing the carried state.

    ``continuity``: attach the carried-density fields of the continuity
    tier.  rhop starts at zeros with age 0 — the first step's
    age % RESUM_EVERY == 0 re-summation fills it before the EOS ever
    reads it."""
    table = pm.build_planes(pos, vel, ids, params, geom, x_origin=x_origin,
                            with_ids=True, active=active)
    planes = table.planes
    rhop = jnp.zeros_like(planes[6]) if continuity else None
    age = jnp.int32(0) if continuity else None
    return IncState(fields6=planes[:6], idp=planes[6],
                    overflow=table.overflow, mig_overflow=jnp.int32(0),
                    rhop=rhop, age=age)


def to_flat(state: IncState, params: SimParams, geom: PlaneGeom, n: int):
    """Planes -> flat channel rows (x,y,z,vx,vy,vz,id[,rho]) in slot order;
    callers align by id.

    rho is recomputed with one density sweep when diagnostics are on (it is
    not carried across steps).  ``n`` bounds the output capacity (valid
    slots never exceed the particle count).
    """
    valid = (state.fields6[0] < SENTINEL * 0.5) & interior_mask(geom)[None]
    channels = [state.fields6, state.idp]
    if params.diagnostics:
        from .pallas_sph import density_planes
        halo6 = pm.halo_x(state.fields6)
        channels.append(density_planes(halo6[:3], params, geom))
    return compact_flagged(channels, valid, n)


def to_flat_lite(state: IncState, geom: PlaneGeom, n: int):
    """Positions + id only (4 channels) — the in-scan frame-recording
    extraction for movie rollouts (SURVEY.md §3.3 render-frame stack).
    Same slot order as to_flat; order is set-valued per frame."""
    valid = (state.fields6[0] < SENTINEL * 0.5) & interior_mask(geom)[None]
    return compact_flagged([state.fields6[:3], state.idp], valid, n)


# ---------------------------------------------------------------------------
# the incremental step
# ---------------------------------------------------------------------------

def extract_movers(new6, idp, flagp, geom: PlaneGeom, m_cap: int,
                   rhop=None):
    """Pull flagged movers straight out of the post-step planes.

    new6: (6, K, pz, n_bx, py, 128) post-step pos/vel planes; idp the carried
    id plane; flagp the force sweep's mover-flag plane.  Returns ((7, m_cap)
    mover rows, live count, flagged total) — or (8, m_cap) with the
    continuity tier's post-step density plane ``rhop`` riding as a trailing
    channel (id stays at index 6: the mover liveness encoding of
    exchange_movers keys on it).
    """
    flags = (flagp > 0.5) & interior_mask(geom)[None]
    staged_total = jnp.sum(flags).astype(jnp.int32)
    channels = [new6, idp]
    if rhop is not None:
        channels.append(rhop)
    movers, m = compact_flagged(channels, flags, m_cap)
    return movers, m, staged_total


def exchange_movers(movers, m, x_origin, width, mig_cap: int, n_dev: int,
                    axis: str):
    """Ship slab-leaving movers to the x-neighbor devices.

    The mover set IS the migration traffic under spatial sharding: only a
    particle that changed cell can have crossed a slab face, so the
    per-step payload is two fixed (nf, mig_cap) buffers instead of the
    full-path's particle-array repack (parallel/sharded.migrate).  nf = 7,
    or 8 with the continuity tier's rho channel (id stays at index 6).
    Returns (merged (nf, M + 2*mig_cap), live mask, n lost to mig_cap).
    """
    nf = movers.shape[0]
    max_out = movers.shape[1]
    jdx = jnp.arange(max_out, dtype=jnp.int32)
    live = jdx < m
    x = movers[0]
    go_l = live & (x < x_origin)
    go_r = live & (x >= x_origin + width)
    # group: stayers(0) < left(1) < right(2) < dead(3); one multi-operand
    # sort carries all fields
    key = (go_l.astype(jnp.int32) + 2 * go_r.astype(jnp.int32)
           + jnp.where(live, 0, 3))
    out = jax.lax.sort((key,) + tuple(movers[i] for i in range(nf)),
                       num_keys=1, is_stable=False)
    key_s = out[0]
    rows = jnp.stack(out[1:], axis=0)                    # (nf, M)
    n_stay = jnp.sum(key_s == 0)
    n_l = jnp.sum(key_s == 1)
    n_r = jnp.sum(key_s == 2)
    ar = jnp.arange(mig_cap, dtype=jnp.int32)

    def pack(start, count):
        mask = ar < jnp.minimum(count, mig_cap)
        take = jnp.clip(start + ar, 0, max_out - 1)
        buf = jnp.where(mask[None, :], rows[:, take], 0.0)
        # ship id + 1: ppermute zero-fills devices with no sender (the mesh
        # edges), and a raw 0.0 id would decode as a live phantom particle
        return buf.at[6].set(jnp.where(mask, buf[6] + 1.0, 0.0))

    buf_l = pack(n_stay, n_l)
    buf_r = pack(n_stay + n_l, n_r)
    lost = (jnp.maximum(n_l - mig_cap, 0)
            + jnp.maximum(n_r - mig_cap, 0)).astype(jnp.int32)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i, i - 1) for i in range(1, n_dev)]
    rb = jax.lax.ppermute(buf_r, axis, fwd)              # from left nbr
    lb = jax.lax.ppermute(buf_l, axis, bwd)              # from right nbr
    arrived = jnp.concatenate([rb, lb], axis=1)          # (7, 2*mig_cap)
    arrived = arrived.at[6].set(arrived[6] - 1.0)        # decode; 0 -> dead
    stay = jdx < n_stay
    rows = rows.at[6].set(jnp.where(stay, rows[6], -1.0))
    merged = jnp.concatenate([rows, arrived], axis=1)
    return merged, merged[6] >= 0.0, lost


def step_planes(state: IncState, params: SimParams, geom: PlaneGeom,
                m_cap: int, x_origin=None, exchange=None,
                wall_params: SimParams = None, n_dev: int = 1,
                mig_cap: int = 0, axis: str = None) -> IncState:
    """One SPH step entirely in plane space.

    halo -> density sweep -> fused force+integrate+collide sweep, which
    also flags the slots whose particle left its cell -> gather the movers
    -> consolidate (kept slots compacted per cell, movers scattered onto
    the free ranks of their new cells).

    Sharded mode (parallel/sharded.py): ``x_origin`` is the device's slab
    binning origin, ``exchange`` the cross-device ghost-lane fill,
    ``wall_params`` the global-domain walls, and slab-leaving movers go to
    the x neighbors via ``exchange_movers`` (their loss to ``mig_cap`` is
    counted into ``mig_overflow``, separately from the physics-capacity
    ``overflow``).

    Continuity tier (``state.rhop is not None``): the density sweep is
    SKIPPED — the EOS reads the carried rho plane, the force sweep emits
    next step's rho in the same pair loop (pallas_sph ``_ForceMath``), and
    movers carry rho as an 8th channel.  The seeding/resum sweep runs under
    one lax.cond.
    """
    from .pallas_sph import density_planes, accel_planes

    continuity = state.rhop is not None
    planes6 = pm.halo_x(state.fields6)
    if exchange is not None:
        planes6 = exchange(planes6, n_pos_fields=3)
    with jax.named_scope("sph_density"):
        if continuity:
            if params.cont_form in ("sum", "relax"):
                need = state.age == 0
            else:
                need = (state.age % RESUM_EVERY) == 0
            rho_p = jax.lax.cond(
                need, lambda _: density_planes(planes6[:3], params, geom),
                lambda _: state.rhop, None)
        else:
            rho_p = density_planes(planes6[:3], params, geom)
        rho_h = pm.halo_x(rho_p)
    if exchange is not None:
        rho_h = exchange(rho_h[None], n_pos_fields=0)[0]
    slab = None
    if x_origin is not None:
        width = jnp.float32(geom.nx * params.cell)
        x0 = jnp.asarray(x_origin, jnp.float32)
        slab = jnp.stack([x0, x0 + width])
    with jax.named_scope("sph_force"):
        outs = accel_planes(planes6, rho_h, params, geom,
                            fuse_integrate=True, emit_movers=True,
                            wall_params=wall_params, slab=slab,
                            continuity=continuity)
    if continuity:
        new6, rho_new, flagp = outs
    else:
        (new6, flagp), rho_new = outs, None
    with jax.named_scope("movers"):
        movers, m, staged_total = extract_movers(new6, state.idp, flagp,
                                                 geom, m_cap, rhop=rho_new)
        live = jnp.arange(movers.shape[1], dtype=jnp.int32) < m
        lost_ship = jnp.int32(0)
        if n_dev > 1:
            movers, live, lost_ship = exchange_movers(
                movers, m, jnp.asarray(x_origin, jnp.float32), width,
                mig_cap, n_dev, axis)
    with jax.named_scope("consolidate"):
        cons = consolidate(new6, state.idp, flagp, movers, live, params,
                           geom, x_origin, rhop=rho_new)
    if continuity:
        fields6, idp, rho_c, lost = cons
        age = state.age + 1
    else:
        fields6, idp, lost = cons
        rho_c, age = None, None
    overflow = state.overflow + (staged_total - m) + lost
    return IncState(fields6=fields6, idp=idp, overflow=overflow,
                    mig_overflow=state.mig_overflow + lost_ship,
                    rhop=rho_c, age=age)


# ---------------------------------------------------------------------------
# flat-state entry points (solver registry / run)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("params", "n", "continuity"))
def _inc_convert_in(pos, vel, ids, overflow0, params: SimParams, n: int,
                    continuity: bool = False):
    geom = pm.geometry(params)
    state0 = to_planes(pos, vel, ids, params, geom, continuity=continuity)
    return state0._replace(overflow=state0.overflow + overflow0)


@functools.partial(jax.jit, static_argnames=("params", "n_steps", "n"))
def _inc_scan_chunk(state: IncState, params: SimParams, n_steps: int,
                    n: int) -> IncState:
    geom = pm.geometry(params)
    m_cap = mover_capacity(n)

    def body(s, _):
        return step_planes(s, params, geom, m_cap), None

    return jax.lax.scan(body, state, None, length=n_steps)[0]


@functools.partial(jax.jit, static_argnames=("params", "n"))
def _inc_convert_out(state: IncState, params: SimParams, n: int):
    geom = pm.geometry(params)
    vals, cnt = to_flat(state, params, geom, n)
    return vals, cnt, state.overflow


def _flat_state(vals, cnt, overflow, params: SimParams, n: int):
    """to_flat rows -> models.State; rows past ``cnt`` (slots lost to
    overflow) park at the bounds corner with vel 0 and id -1."""
    from ..models.state import State
    live = jnp.arange(vals.shape[1], dtype=jnp.int32) < cnt
    lo = params.bounds_min
    dim = params.dim
    pos = jnp.stack([jnp.where(live, vals[d], lo[d])
                     for d in range(dim)], axis=-1)
    vel = jnp.stack([jnp.where(live, vals[3 + d], 0.0)
                     for d in range(dim)], axis=-1)
    ids = jnp.where(live, vals[6].astype(jnp.int32), -1)
    if params.diagnostics:
        rho = jnp.where(live, vals[7], params.rest_density)
        pres = physics_eos(rho, params)
    else:
        rho = jnp.full((n,), params.rest_density, jnp.float32)
        pres = jnp.zeros((n,), jnp.float32)
    return State(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                 overflow=overflow)


def run_inc(state, params: SimParams, n_steps: int, chunk: int = None,
            continuity: bool = False):
    """models.State -> models.State after n_steps on the incremental path.

    One planes conversion per rollout and, unless ``chunk`` splits it, one
    device program for all the steps.  ``continuity``: carry density in the
    planes and skip the per-step summation sweep (see step_planes).
    """
    n = state.n
    chunk = chunk or max(n_steps, 1)
    s = _inc_convert_in(state.pos, state.vel, state.ids, state.overflow,
                        params, n, continuity=continuity)
    done = 0
    while done < n_steps:
        k = min(chunk, n_steps - done)
        s = _inc_scan_chunk(s, params, k, n)
        done += k
    return _flat_state(*_inc_convert_out(s, params, n), params, n)


def physics_eos(rho, params):
    from . import physics
    return physics.eos_pressure(
        jnp.maximum(rho, 1e-3 * params.rest_density), params)


@functools.partial(jax.jit, static_argnames=("params", "n_steps",
                                             "record_every", "n"))
def _inc_rollout(state: IncState, params: SimParams, n_steps: int,
                 record_every: int, n: int):
    geom = pm.geometry(params)
    m_cap = mover_capacity(n)

    def inner(s, _):
        return step_planes(s, params, geom, m_cap), None

    def outer(s, _):
        s = jax.lax.scan(inner, s, None, length=record_every)[0]
        vals, cnt = to_flat_lite(s, geom, n)
        return s, (vals, cnt)

    return jax.lax.scan(outer, state, None, length=n_steps // record_every)


def rollout_inc(state, params: SimParams, n_steps: int,
                record_every: int = 1, continuity: bool = False):
    """models.State -> (final State, traj) with in-scan frame recording.

    The planes stay resident across the whole rollout (one conversion per
    call, like run_inc); every ``record_every`` steps the scan emits a
    position frame via ``to_flat_lite``.  traj has shape
    (n_steps//record_every, N, dim); frame order is set-valued (particles
    are plane-ordered; dropped rows park at bounds_min).
    """
    n = state.n
    n_frames = n_steps // record_every
    s = _inc_convert_in(state.pos, state.vel, state.ids, state.overflow,
                        params, n, continuity=continuity)
    dim = params.dim
    if n_frames:
        s, (vals, cnts) = _inc_rollout(s, params, n_frames * record_every,
                                       record_every, n)
        live = (jnp.arange(vals.shape[2], dtype=jnp.int32)[None, :]
                < cnts[:, None])
        traj = jnp.stack([jnp.where(live, vals[:, d], params.bounds_min[d])
                          for d in range(dim)], axis=-1)
    else:
        traj = jnp.zeros((0, n, dim), jnp.float32)
    # leftover steps that don't fill a whole frame interval
    rem = n_steps - n_frames * record_every
    if rem:
        s = _inc_scan_chunk(s, params, rem, n)
    final = _flat_state(*_inc_convert_out(s, params, n), params, n)
    return final, traj
