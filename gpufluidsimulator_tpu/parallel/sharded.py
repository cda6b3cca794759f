"""Spatial domain decomposition: shard_map + ppermute ghost exchange.

Reference counterpart: none exists (single-GPU reference); this implements
the multi-device requirement of BASELINE.json: the spatial grid is sharded
across a device mesh with halo exchange of ghost particles via
jax.lax.ppermute (config 5: 4M particles).

Design (no MPI-style bookkeeping):
  * each device owns an x slab of the global cell grid (nx_local cells) and a
    fixed-capacity particle array (N_cap slots; free slots are inactive:
    ids == -1, pos parked at the sentinel);
  * per step, in one compiled program per device (shard_map over a 1D mesh):
      1. MIGRATION — particles that left the slab are grouped by the key
         argsort, packed into fixed-size (M_cap) buffers, ppermute'd to the
         neighbor, and arrivals land in the free tail slots.  Capacity
         misses are counted (mig_overflow), never silently dropped.
      2. local bin -> GHOST EXCHANGE — the outermost halo lanes of the rank
         planes are filled from the neighbor's edge cells via ppermute (the
         cross-device twin of planes.halo_x) -> neighbour sweeps ->
         integrate against the GLOBAL walls (slab edges are open).
  * everything lives inside jit; whole rollouts run as shard_map(lax.scan) —
    one program, halos and migration riding collectives inside the scan.

Tested on the 8-virtual-device CPU mesh (SURVEY.md §4.5); the same code
drives a multi-GPU mesh (NCCL collectives).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.params import SimParams
from ..models.state import State
from ..ops import pallas_sph
from ..ops import planes as pm
from .mesh import AXIS, make_mesh


def local_params(params: SimParams, n_dev: int) -> Tuple[SimParams, int]:
    """Params whose grid covers ONE x slab of nx_local cells (walls stay
    global — pass the original params as wall_params)."""
    nx_global = params.grid_res[0]
    nx_local = -(-nx_global // n_dev)
    width = nx_local * params.cell
    hi = list(params.bounds_max)
    hi[0] = params.bounds_min[0] + width
    return params.replace(bounds_max=tuple(hi)), nx_local


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def migrate(pos, vel, ids, x_origin, width, m_cap: int, n_dev: int):
    """Ship particles that left this device's slab to the neighbor device.

    Returns (pos, vel, ids, mig_overflow); mig_overflow counts send-buffer
    and landing-capacity misses (observable; tests assert 0).
    """
    n, d = pos.shape
    active = ids >= 0
    x = pos[:, 0]
    go_l = active & (x < x_origin)
    go_r = active & (x >= x_origin + width)
    # group: stayers(0) < leavers-left(1) < leavers-right(2) < inactive(3);
    # one multi-operand sort carries the fields
    key = (go_l.astype(jnp.int32) + 2 * go_r.astype(jnp.int32)
           + jnp.where(active, 0, 3))
    ops = ((key,) + tuple(pos[:, j] for j in range(d))
           + tuple(vel[:, j] for j in range(d)) + (ids,))
    # unstable: order within each group is irrelevant (stayers get rebinned,
    # leavers land in arbitrary free tail slots on the neighbor anyway)
    out = jax.lax.sort(ops, num_keys=1, is_stable=False)
    key = out[0]
    pos = jnp.stack(out[1:1 + d], axis=-1)
    vel = jnp.stack(out[1 + d:1 + 2 * d], axis=-1)
    ids = out[-1]

    n_stay = jnp.sum(key == 0)
    n_l = jnp.sum(key == 1)
    n_r = jnp.sum(key == 2)
    ar = jnp.arange(m_cap, dtype=jnp.int32)
    vals = jnp.concatenate([pos, vel], axis=1)            # (N, 2d)

    def pack(start, count):
        mask = ar < jnp.minimum(count, m_cap)
        take = jnp.clip(start + ar, 0, n - 1)
        buf = jnp.where(mask[:, None], vals[take], 0.0)
        bids = jnp.where(mask, ids[take], -1)
        return buf, bids, mask

    buf_l, ids_l, mask_l = pack(n_stay, n_l)
    buf_r, ids_r, mask_r = pack(n_stay + n_l, n_r)
    mig_ovf = (jnp.maximum(n_l - m_cap, 0)
               + jnp.maximum(n_r - m_cap, 0)).astype(jnp.int32)

    # deactivate everything past the stayers (leavers shipped, tail free)
    live = jnp.arange(n) < n_stay
    ids = jnp.where(live, ids, -1)
    pos = jnp.where(live[:, None], pos, pm.SENTINEL)
    vel = jnp.where(live[:, None], vel, 0.0)

    if n_dev > 1:
        fwd = [(i, i + 1) for i in range(n_dev - 1)]
        bwd = [(i, i - 1) for i in range(1, n_dev)]
        # right-going buffer lands on the next device, left-going on previous
        rb = jax.lax.ppermute(buf_r, AXIS, fwd)
        ri = jax.lax.ppermute(ids_r, AXIS, fwd)
        rm = jax.lax.ppermute(mask_r, AXIS, fwd)
        lb = jax.lax.ppermute(buf_l, AXIS, bwd)
        li = jax.lax.ppermute(ids_l, AXIS, bwd)
        lm = jax.lax.ppermute(mask_l, AXIS, bwd)
    else:
        rb, ri, rm = buf_r * 0, ids_r * 0 - 1, mask_r & False
        lb, li, lm = buf_l * 0, ids_l * 0 - 1, mask_l & False

    arr_vals = jnp.concatenate([rb, lb], axis=0)          # (2m, 2d)
    arr_ids = jnp.concatenate([ri, li], axis=0)
    arr_mask = jnp.concatenate([rm, lm], axis=0)
    # landing slots must be free: count any stayer still in the tail
    mig_ovf = mig_ovf + jnp.sum(
        (jnp.arange(n) >= n - 2 * m_cap) & live).astype(jnp.int32)

    tail = slice(n - 2 * m_cap, n)
    pos = pos.at[tail].set(jnp.where(arr_mask[:, None],
                                     arr_vals[:, :d], pm.SENTINEL))
    vel = vel.at[tail].set(jnp.where(arr_mask[:, None], arr_vals[:, d:], 0.0))
    ids = ids.at[tail].set(jnp.where(arr_mask, arr_ids, -1))
    return pos, vel, ids, mig_ovf


# ---------------------------------------------------------------------------
# ghost-plane exchange
# ---------------------------------------------------------------------------

def make_exchange(n_dev: int, nx_local: int):
    """Cross-device twin of planes.halo_x: fill the outermost halo lanes of
    the rank-plane stack from the neighbor device's edge cells.

    The rightmost interior cell sits at lane ((nx_local-1) % 126) + 1 of the
    last tile (the tile may be partially filled); its halo lane is one to the
    right.  The leftmost interior cell is always lane 1 of tile 0.
    """
    if n_dev == 1:
        return None
    last_lane = (nx_local - 1) % pm.TILE_X + 1

    def exchange(stack, n_pos_fields: int):
        # stack (F, K, pz, n_bx, py, 128)
        f = stack.shape[0]
        fill = jnp.asarray([pm.SENTINEL] * n_pos_fields
                           + [0.0] * (f - n_pos_fields), jnp.float32)
        fill = fill.reshape((f,) + (1,) * (stack.ndim - 3))
        d = jax.lax.axis_index(AXIS)
        fwd = [(i, i + 1) for i in range(n_dev - 1)]
        bwd = [(i, i - 1) for i in range(1, n_dev)]

        right_edge = stack[..., -1, :, last_lane]          # (F, K, pz, py)
        left_edge = stack[..., 0, :, 1]
        from_left = jax.lax.ppermute(right_edge, AXIS, fwd)
        from_right = jax.lax.ppermute(left_edge, AXIS, bwd)
        from_left = jnp.where(d > 0, from_left, fill)
        from_right = jnp.where(d < n_dev - 1, from_right, fill)
        stack = stack.at[..., 0, :, 0].set(from_left)
        stack = stack.at[..., -1, :, last_lane + 1].set(from_right)
        return stack

    return exchange


# ---------------------------------------------------------------------------
# sharded state / step / rollout
# ---------------------------------------------------------------------------

class ShardedState(NamedTuple):
    """Per-device stacked state: leading axis = device; -1 ids = free slot."""
    pos: jnp.ndarray           # (n_dev, N_cap, d)
    vel: jnp.ndarray           # (n_dev, N_cap, d)
    rho: jnp.ndarray           # (n_dev, N_cap)
    pres: jnp.ndarray          # (n_dev, N_cap)
    ids: jnp.ndarray           # (n_dev, N_cap) int32
    overflow: jnp.ndarray      # (n_dev,) int32 cell-capacity drops
    mig_overflow: jnp.ndarray  # (n_dev,) int32 migration capacity misses


def _local_step(pos, vel, ids, params: SimParams, params_loc: SimParams,
                nx_local: int, m_cap: int, n_dev: int):
    width = jnp.float32(nx_local * params.cell)
    x_origin = (jnp.float32(params.bounds_min[0])
                + jax.lax.axis_index(AXIS).astype(jnp.float32) * width)
    pos, vel, ids, mig_ovf = migrate(pos, vel, ids, x_origin, width,
                                     m_cap, n_dev)
    pos, vel, rho, pres, ids, ovf = pallas_sph.step_pallas(
        pos, vel, ids, params_loc, x_origin=x_origin,
        active=ids >= 0, exchange=make_exchange(n_dev, nx_local),
        wall_params=params)
    return pos, vel, rho, pres, ids, ovf, mig_ovf


def run_sharded(sstate: ShardedState, params: SimParams, mesh: Mesh,
                n_steps: int, m_cap: int) -> ShardedState:
    """Advance n_steps: ONE jitted program, scan inside shard_map, halos and
    migration riding collectives inside the scan."""
    n_dev = mesh.devices.size
    params_loc, nx_local = local_params(params, n_dev)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS),) * 7,
        check_vma=False)
    def fn(pos, vel, ids, ovf0, mig0):
        n_cap = pos.shape[1]
        zero = jnp.zeros((1, n_cap), jnp.float32)

        def body(carry, _):
            pos, vel, ids, _, _, ovf_acc, mig_acc = carry
            pos, vel, rho, pres, ids, ovf, mig = _local_step(
                pos[0], vel[0], ids[0], params, params_loc,
                nx_local, m_cap, n_dev)
            # overflow counters accumulate across the scan (observable)
            return (pos[None], vel[None], ids[None], rho[None], pres[None],
                    ovf_acc + ovf.reshape(1), mig_acc + mig.reshape(1)), None

        carry = (pos, vel, ids, zero, zero, ovf0, mig0)
        (pos, vel, ids, rho, pres, ovf, mig), _ = jax.lax.scan(
            body, carry, None, length=n_steps)
        return pos, vel, rho, pres, ids, ovf, mig

    pos, vel, rho, pres, ids, ovf, mig = jax.jit(fn)(
        sstate.pos, sstate.vel, sstate.ids, sstate.overflow,
        sstate.mig_overflow)
    return ShardedState(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                        overflow=ovf, mig_overflow=mig)


def run_sharded_inc(sstate: ShardedState, params: SimParams, mesh: Mesh,
                    n_steps: int, mig_cap: Optional[int] = None,
                    continuity: bool = False) -> ShardedState:
    """Advance n_steps on the incremental (planes-resident) pipeline.

    Each device's rank-plane stack is the scan-carried state (one
    ``inc.to_planes`` conversion per rollout, not per step); ghost lanes
    and slab-crossing movers ride collectives inside the scan — the
    migration payload is two (7, mig_cap) mover buffers per step instead of the
    full-path's particle-array repack (ops/inc.py ``exchange_movers``).
    Physics-capacity losses (mover stage, arrival ranks, cell ranks)
    accumulate into ``overflow``; mover-buffer capacity misses
    accumulate into ``mig_overflow`` — the two failure modes stay
    independently observable, exactly as on ``run_sharded``.

    ``continuity``: the carried-density tier (ops/inc.py) — rho rides as
    an 8th plane/mover channel over the same exchanges.
    """
    from ..ops import inc
    n_dev = mesh.devices.size
    params_loc, nx_local = local_params(params, n_dev)
    params_loc = params_loc.replace(diagnostics=False)
    geom = pm.geometry(params_loc)
    n_cap = sstate.pos.shape[1]
    mv_cap = inc.mover_capacity(n_cap)
    if mig_cap is None:
        mig_cap = max(128, n_cap // 64)
    exchange = make_exchange(n_dev, nx_local)
    width = nx_local * params.cell
    d = sstate.pos.shape[-1]

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS),) * 7,
        check_vma=False)
    def fn(pos, vel, ids, ovf0, mig0):
        x_origin = (jnp.float32(params.bounds_min[0])
                    + jax.lax.axis_index(AXIS).astype(jnp.float32)
                    * jnp.float32(width))
        s0 = inc.to_planes(pos[0], vel[0], ids[0], params_loc, geom,
                           x_origin=x_origin, active=ids[0] >= 0,
                           continuity=continuity)

        def body(s, _):
            return inc.step_planes(
                s, params_loc, geom, mv_cap, x_origin=x_origin,
                exchange=exchange, wall_params=params, n_dev=n_dev,
                mig_cap=mig_cap, axis=AXIS), None

        sN, _ = jax.lax.scan(body, s0, None, length=n_steps)
        vals, cnt = inc.to_flat(sN, params_loc, geom, n_cap)
        live = jnp.arange(vals.shape[1], dtype=jnp.int32) < cnt
        posn = jnp.stack([jnp.where(live, vals[c], pm.SENTINEL)
                          for c in range(d)], axis=-1)[:n_cap]
        veln = jnp.stack([jnp.where(live, vals[3 + c], 0.0)
                          for c in range(d)], axis=-1)[:n_cap]
        idsn = jnp.where(live, vals[6].astype(jnp.int32), -1)[:n_cap]
        rho = jnp.full((n_cap,), params.rest_density, jnp.float32)
        pres = jnp.zeros((n_cap,), jnp.float32)
        return (posn[None], veln[None], rho[None], pres[None], idsn[None],
                ovf0 + sN.overflow.reshape(1),
                mig0 + sN.mig_overflow.reshape(1))

    pos, vel, rho, pres, ids, ovf, mig = jax.jit(fn)(
        sstate.pos, sstate.vel, sstate.ids, sstate.overflow,
        sstate.mig_overflow)
    return ShardedState(pos=pos, vel=vel, rho=rho, pres=pres, ids=ids,
                        overflow=ovf, mig_overflow=mig)


# ---------------------------------------------------------------------------
# host-side distribute / gather
# ---------------------------------------------------------------------------

def _slab_arrays(params: SimParams, state: State, n_dev: int,
                 n_cap: Optional[int] = None, m_cap: Optional[int] = None):
    """Host-side slab packing shared by distribute / distribute_global."""
    _, nx_local = local_params(params, n_dev)
    width = nx_local * params.cell

    pos = np.asarray(state.pos)
    vel = np.asarray(state.vel)
    ids = np.asarray(state.ids)
    dev = np.clip(((pos[:, 0] - params.bounds_min[0]) // width
                   ).astype(np.int64), 0, n_dev - 1)
    counts = np.bincount(dev, minlength=n_dev)
    if m_cap is None:
        m_cap = max(64, int(counts.max()) // 8)
    if n_cap is None:
        n_cap = int(counts.max() * 1.5) + 2 * m_cap
    n_cap = -(-n_cap // 8) * 8

    d = pos.shape[1]
    spos = np.full((n_dev, n_cap, d), pm.SENTINEL, np.float32)
    svel = np.zeros((n_dev, n_cap, d), np.float32)
    sids = np.full((n_dev, n_cap), -1, np.int32)
    for dd in range(n_dev):
        sel = dev == dd
        c = int(sel.sum())
        if c > n_cap - 2 * m_cap:
            raise ValueError(f"device {dd} over capacity: {c} > "
                             f"{n_cap - 2 * m_cap}")
        spos[dd, :c] = pos[sel]
        svel[dd, :c] = vel[sel]
        sids[dd, :c] = ids[sel]
    z = np.zeros((n_dev, n_cap), np.float32)
    zi = np.zeros((n_dev,), np.int32)
    arrays = dict(pos=spos, vel=svel, rho=z, pres=z.copy(), ids=sids,
                  overflow=zi, mig_overflow=zi.copy())
    return arrays, m_cap


def distribute(params: SimParams, state: State, mesh: Mesh,
               n_cap: Optional[int] = None,
               m_cap: Optional[int] = None) -> Tuple[ShardedState, int]:
    """Split a global State into per-device fixed-capacity slabs."""
    arrays, m_cap = _slab_arrays(params, state, mesh.devices.size,
                                 n_cap, m_cap)
    from .mesh import shard_leading
    sh = shard_leading(mesh)
    put = lambda a: jax.device_put(jnp.asarray(a), sh)
    return ShardedState(**{k: put(v) for k, v in arrays.items()}), m_cap


def distribute_global(params: SimParams, state: State, mesh: Mesh,
                      n_cap: Optional[int] = None,
                      m_cap: Optional[int] = None
                      ) -> Tuple[ShardedState, int]:
    """Multi-process (multi-host) distribute over a GLOBAL device mesh.

    Every process computes the same deterministic slab arrays from the
    replicated host State and materializes only its addressable shards
    (jax.make_array_from_callback) — the DCN path of SURVEY.md §5.8; see
    parallel.mesh.init_distributed and tests/test_multihost.py."""
    arrays, m_cap = _slab_arrays(params, state, mesh.devices.size,
                                 n_cap, m_cap)
    from .mesh import shard_leading
    sh = shard_leading(mesh)

    def put(a):
        return jax.make_array_from_callback(
            a.shape, sh, lambda idx, a=a: a[idx])

    return ShardedState(**{k: put(v) for k, v in arrays.items()}), m_cap


def gather(sstate: ShardedState, n_total: int) -> State:
    """Collect a ShardedState back into one global State (spawn order)."""
    pos = np.asarray(sstate.pos).reshape(-1, sstate.pos.shape[-1])
    vel = np.asarray(sstate.vel).reshape(-1, sstate.vel.shape[-1])
    rho = np.asarray(sstate.rho).reshape(-1)
    pres = np.asarray(sstate.pres).reshape(-1)
    ids = np.asarray(sstate.ids).reshape(-1)
    live = ids >= 0
    assert live.sum() == n_total, (
        f"lost particles: {live.sum()} != {n_total}")
    order = np.argsort(ids[live])
    return State(
        pos=jnp.asarray(pos[live][order]), vel=jnp.asarray(vel[live][order]),
        rho=jnp.asarray(rho[live][order]),
        pres=jnp.asarray(pres[live][order]),
        ids=jnp.asarray(np.sort(ids[live])),
        overflow=jnp.asarray(int(np.asarray(sstate.overflow).sum()),
                             jnp.int32))


class ShardedSim:
    """Facade mirroring FluidSim for the multi-chip path."""

    def __init__(self, params: SimParams, state: State,
                 mesh: Optional[Mesh] = None,
                 n_cap: Optional[int] = None,
                 m_cap: Optional[int] = None,
                 method: str = "pallas"):
        if method not in ("pallas", "pallas_inc", "pallas_inc_cont"):
            raise ValueError(f"unknown sharded method {method!r}")
        self.params = params
        self.mesh = mesh or make_mesh()
        self.n_total = state.n
        self.method = method
        self.sstate, self.m_cap = distribute(params, state, self.mesh,
                                             n_cap, m_cap)

    def step(self, n: int = 1) -> ShardedState:
        if self.method in ("pallas_inc", "pallas_inc_cont"):
            self.sstate = run_sharded_inc(
                self.sstate, self.params, self.mesh, n,
                continuity=self.method == "pallas_inc_cont")
        else:
            self.sstate = run_sharded(self.sstate, self.params, self.mesh,
                                      n, self.m_cap)
        return self.sstate

    def gather(self) -> State:
        return gather(self.sstate, self.n_total)
