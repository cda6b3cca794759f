"""The SPH neighbour sweeps over the rank-planar cell grid (config 3+).

Reference counterparts: ``computeDensityPressureKernel`` and
``computeForcesKernel`` — the two hot CUDA kernels (SURVEY.md §3.1), one
thread per cell-sorted particle looping over the 27 neighbour cells.  The
rank planes (ops/planes.py) are that cell-sorted structure with a fixed
capacity of K slots per cell instead of ``cellEnd``; every sweep reads them
in one of two ways, chosen once from the platform (``sweep_impl``):

  * ``"triton"`` (GPU): a Pallas kernel through Triton.  One program owns a
    tile of a few y rows x 128 x cells at one z plane, one query
    slot per lane.  Neighbour cells are plain pointer offsets into the
    flattened plane (the layout's ghost rows, ghost planes and halo lanes
    keep every offset in bounds), source ranks loop up to the block's own
    occupancy bound, accumulators live in registers and nothing is carried
    between programs.
  * ``"plain"`` (CPU, and the reference the kernel is tested against): the
    same pair math in ``jax.numpy`` over static shifted slices of the
    planes, all K source ranks, with empty slots neutralised by their
    sentinel positions.

Both compute the identical per-pair terms (``_density_pair`` and
``_ForceMath``), so they differ only in summation order.  Outputs are
defined on the query region (interior z planes, the y rows of the interior
blocks, all x lanes); on empty or non-owning slots they hold the fill
values (0, or the sentinel for post-step positions).  The Triton kernel
leaves slots outside the query region unwritten; every consumer masks them.

Distances use direct coordinate differences in f32 (positions are O(1) in
domain units; the |a|^2-2ab expansion would lose ~3 digits near r->0).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.params import SimParams
from . import kernels, physics
from . import planes as pm
from .planes import LANES, ROWS_PER_BLOCK, TILE_X, PlaneGeom

# Triton launch shapes, (y rows per program -> rows * 128 query slots,
# warps per program, software-pipeline stages of the rank loops), chosen by
# measurement on the H100 at config 4 (PERF.md).
DENSITY_LAUNCH = (2, 4, 2)
FORCE_LAUNCH = (1, 4, 2)


def sweep_impl(platform: str = None) -> str:
    """The sweep implementation for a JAX platform: the Triton kernel on the
    GPU, the plain version on the CPU.  Any other platform is an error."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "plain"
    raise RuntimeError(f"no SPH sweep implementation for platform "
                       f"{platform!r} (supported: gpu, cpu)")


def _dzs(dim: int):
    return (-1, 0, 1) if dim == 3 else (0,)


# --------------------------------------------------------------------------
# pair math shared by both implementations
# --------------------------------------------------------------------------

def _density_pair(q, c, acc, h2, dim: int):
    ddx = q[0] - c[0]
    ddy = q[1] - c[1]
    r2 = ddx * ddx + ddy * ddy
    if dim == 3:
        ddz = q[2] - c[2]
        r2 = r2 + ddz * ddz
    d = jnp.maximum(h2 - r2, 0.0)
    return acc + d * d * d


def fold_eos(field_planes, rho_planes, params: SimParams):
    """Per-slot force-sweep factors from density: (m_spiky p/rho^2,
    sqrt(visc coef m mu)/rho), with empty slots at rest density.  Computed
    once per step so the pair loop reads them instead of re-evaluating the
    EOS for every candidate."""
    rest = params.rest_density
    valid = field_planes[0] < pm.SENTINEL * 0.5
    rho_c = jnp.where(valid, jnp.maximum(rho_planes, 1e-3 * rest), rest)
    pres = physics.eos_pressure(rho_c, params)
    fm = _ForceMath(params)
    return jnp.stack([fm.m_spiky * pres / (rho_c * rho_c),
                      fm.m_visc_sqrt / rho_c])


class _ForceMath:
    """Constants and per-pair / per-query terms of the fused force sweep.

    Query and candidate channels: 0:x 1:y 2:z 3:vx 4:vy 5:vz
    6:m_spiky*p/rho^2 7:m_visc_sqrt/rho (``fold_eos``), plus for the query
    an optional 8th channel kappa*rho_i/m_visc_sqrt (delta-SPH).

    Continuity tier (``continuity``): the density input is the CARRIED rho
    of the incremental path, and the pair loop also accumulates next step's
    density in one of three forms (SimParams.cont_form):

      * "rate": drho/dt = sum_j m (v_i-v_j).gradW with the POLY6 gradient
        (the chain-rule identity d/dt sum m W(x_ij) holds only for the
        kernel the summation density uses), emitted as the explicit-Euler
        update rho + dt*drho/dt and re-synced by a periodic summation
        sweep (ops/inc.RESUM_EVERY).  Optional delta-SPH diffusion rides
        the same accumulator.
      * "relax": the rate update relaxed toward the concurrent summation,
        rho' = (1-l)(rho + dt drho) + l R(x), folded into the single
        accumulator as d4*(dot + kappa_d2*d2).
      * "sum": the exact poly6 summation R(x) at the step's input
        positions, read one step stale by the next EOS.  (Completing it to
        R + dt dR/dt double-corrects against the deferred correction.)

    The deferred-correction pressure term (SimParams.cont_beta) and the
    optional Monaghan alpha viscosity (cont_alpha) act on approaching pairs
    and reuse the continuity accumulation's d2^2*dot product.
    """

    def __init__(self, params: SimParams, continuity: bool = False):
        p = params
        self.p = p
        self.dim = p.dim
        self.continuity = continuity
        self.h = p.h
        self.h2 = p.h * p.h
        c_poly6 = kernels.poly6_coef(p.h, p.dim) * p.particle_mass
        spiky = -kernels.spiky_grad_coef(p.h, p.dim) * p.particle_mass
        self.c_poly6 = c_poly6
        self.m_spiky = spiky
        self.m_visc_sqrt = math.sqrt(kernels.visc_lap_coef(p.h, p.dim)
                                     * p.particle_mass * p.viscosity)
        # continuity: drho = dt * m * sum((vi-vj) . grad W_poly6), grad
        # W_poly6 = -6 c (h^2-r^2)^2 d; negative scale: approaching pairs
        # (dv.dd < 0) raise the density
        self.drho_scale = -6.0 * p.dt * c_poly6
        self.sum_form = continuity and p.cont_form == "sum"
        self.relax_form = continuity and p.cont_form == "relax"
        lam = p.cont_relax if self.relax_form else 0.0
        self.kappa_d2 = (lam * c_poly6 / ((1.0 - lam) * self.drho_scale)
                         if self.relax_form and lam < 1.0 else 0.0)
        self.one_m_l = 1.0 - lam
        # Monaghan alpha: Pi = alpha c h (-mu)/rho0 on approaching pairs
        self.use_alpha = continuity and p.cont_alpha > 0.0
        self.c_av = spiky * p.cont_alpha * p.sound_speed * p.h \
            / p.rest_density
        self.eps_h2 = 0.01 * p.h * p.h
        # delta-SPH: sr += d2^2 * (dot - kappa*(1 - rho_i/rho_j)); 1/rho_j
        # comes off the candidate's viscosity channel, so it needs mu > 0
        self.use_delta = (continuity and not self.sum_form
                          and p.cont_delta > 0.0 and p.viscosity > 0.0)
        self.kappa = 2.0 * p.cont_delta * p.h * p.sound_speed
        self.kappa_over_mv = self.kappa / (self.m_visc_sqrt or 1.0)
        # deferred-correction pressure fold, clamped at the 20%-overdensity
        # pressure scale (an acoustic stabilizer, not a collision force)
        self.use_corr = continuity and p.cont_beta > 0.0
        self.c_corr = (p.cont_beta * spiky * 12.0 * c_poly6 * p.stiffness
                       * p.dt / (p.rest_density ** 2))
        self.corr_cap = spiky * p.stiffness * 0.2 / p.rest_density

    @property
    def n_acc(self) -> int:
        return 5 if self.continuity else 4

    def pair(self, q, c, acc):
        """Accumulate one candidate into (ax, ay, az, sum coef_v[, sr]).
        The self pair needs no guard: every difference is exactly 0, so
        both force terms vanish, and the r2 clamp keeps coef_p finite."""
        dim = self.dim
        qx, qy, qz, qvx, qvy, qvz, qp, qir = q[:8]
        cx, cy, cz, cvx, cvy, cvz, cp, cir = c
        ax, ay, az, sv = acc[:4]
        ddx = qx - cx
        ddy = qy - cy
        r2 = ddx * ddx + ddy * ddy
        if dim == 3:
            ddz = qz - cz
            r2 = r2 + ddz * ddz
        inv_r = jax.lax.rsqrt(jnp.maximum(r2, 1e-16))
        r = r2 * inv_r
        hr = jnp.maximum(self.h - r, 0.0)
        g = hr * hr * inv_r
        psum = qp + cp
        if self.continuity:
            dot = (qvx - cvx) * ddx + (qvy - cvy) * ddy
            if dim == 3:
                dot = dot + (qvz - cvz) * ddz
            d2 = jnp.maximum(self.h2 - r2, 0.0)
            d4 = d2 * d2
            t_dot = d4 * dot
            if self.use_corr:
                psum = psum - jnp.clip(self.c_corr * t_dot,
                                       -self.corr_cap, self.corr_cap)
            if self.use_alpha:
                rr = jax.lax.rsqrt(r2 + self.eps_h2)
                psum = psum - self.c_av * jnp.minimum(dot * (rr * rr), 0.0)
        coef_p = psum * g
        # viscosity mu m (vb-va) lap(r)/(ra rb): the -va term factors out
        # of the pair loop as -qv * sum(coef_v) (see finish)
        coef_v = hr * (qir * cir)
        sv = sv + coef_v
        ax = ax + coef_p * ddx + coef_v * cvx
        ay = ay + coef_p * ddy + coef_v * cvy
        if dim == 3:
            az = az + coef_p * ddz + coef_v * cvz
        if not self.continuity:
            return ax, ay, az, sv
        sr = acc[4]
        if self.sum_form:
            sr = sr + d4 * d2
        elif self.relax_form:
            sr = sr + d4 * (dot + self.kappa_d2 * d2)
        elif self.use_delta:
            sr = sr + d4 * ((dot - self.kappa) + q[8] * cir)
        else:
            sr = sr + t_dot
        return ax, ay, az, sv, sr

    def finish(self, q, acc):
        """-> [ax, ay, az(, sr)] with the factored viscosity term applied
        (2D: the vz channel is all-zero)."""
        out = [acc[c] - q[3 + c] * acc[3] for c in range(3)]
        if self.continuity:
            out.append(acc[4])
        return out

    def epilogue(self, q, out, rho_q, cell_xyz, interior, slab,
                 wall_params, emit_movers: bool):
        """Fused symplectic Euler + gravity + collide on the query slots,
        optional mover flags and continuity density.

        ``cell_xyz``: the slot's own (x cell, plane row, plane z) as int
        arrays; ``interior`` marks owning lanes; ``slab`` = (binning
        x-origin, slab end).  Returns the list of output channels: 6
        pos/vel, then the 0/1 mover flag and the new density if requested.
        """
        p = self.p
        dim = self.dim
        wp = wall_params or p
        valid = q[0] < pm.SENTINEL * 0.5
        grav = p.gravity + (0.0,) * (3 - dim)
        vnew = [q[3 + c] + (out[c] + grav[c]) * p.dt for c in range(dim)]
        pnew = [q[c] + vnew[c] * p.dt for c in range(dim)]
        pnew, vnew = physics.collide_axes(pnew, vnew, wp)
        zero = jnp.zeros_like(q[0])
        p3 = list(pnew) + [zero] * (3 - dim)
        v3 = list(vnew) + [zero] * (3 - dim)
        res = ([jnp.where(valid, x, pm.SENTINEL) for x in p3]
               + [jnp.where(valid, v, 0.0) for v in v3])
        if not emit_movers:
            return res
        # cell-leaving detection while the new position is in registers
        res_xyz = p.grid_res
        cax = p.cells_axis
        x0, x1 = slab

        def cellc(c, n, base):
            f = jnp.floor((pnew[c] - base) * (1.0 / cax[c]))
            return jnp.clip(f.astype(jnp.int32), 0, n - 1)

        gx, row, z = cell_xyz
        moved = cellc(0, res_xyz[0], x0) != gx
        moved |= cellc(1, res_xyz[1], p.bounds_min[1]) + ROWS_PER_BLOCK != row
        if dim == 3:
            moved |= cellc(2, res_xyz[2], p.bounds_min[2]) + 1 != z
        # clipping hides slab exits: a particle leaving through the slab's
        # x faces keeps its clipped edge cell, so flag it explicitly
        moved |= (pnew[0] < x0) | (pnew[0] >= x1)
        moved &= valid & interior
        res.append(moved.astype(jnp.float32))
        if self.continuity:
            if self.sum_form:
                rho_new = self.c_poly6 * out[3]
            elif self.relax_form:
                rho_new = self.one_m_l * (rho_q + self.drho_scale * out[3])
            else:
                rho_new = rho_q + self.drho_scale * out[3]
            res.append(jnp.where(valid, rho_new, 0.0))
        return res


def _default_slab(params: SimParams, slab):
    """(binning x-origin, slab end); the default — the global domain
    padded by one cell — never flags a slab exit on a single device."""
    if slab is None:
        return jnp.asarray([params.bounds_min[0],
                            params.bounds_max[0] + params.cell], jnp.float32)
    return jnp.asarray(slab, jnp.float32)


def _n_out(fuse_integrate, emit_movers, continuity):
    if continuity:
        assert fuse_integrate and emit_movers
    if emit_movers:
        assert fuse_integrate
    return (6 if fuse_integrate else 3) + int(emit_movers) + int(continuity)


def _split_outputs(outs, fuse_integrate, emit_movers, continuity):
    """(C, K, ...) channel stack -> the public return convention."""
    main = outs[:6] if fuse_integrate else outs[:3]
    if continuity:
        return main, outs[7], outs[6]
    if emit_movers:
        return main, outs[6]
    return main


# --------------------------------------------------------------------------
# plain version: static shifted slices, all K source ranks
# --------------------------------------------------------------------------

def _region(geom: PlaneGeom):
    """Static query region: (z slice, y slice, x slice) of the planes."""
    zq = slice(1, geom.nz + 1) if geom.dim == 3 else slice(0, 1)
    yq = slice(ROWS_PER_BLOCK, ROWS_PER_BLOCK * (geom.n_by + 1))
    # one x tile: lanes past the last interior cell + 1 never hold owners
    x_hi = min(LANES - 1, geom.nx + 1) if geom.n_bx == 1 else LANES - 1
    return zq, yq, slice(1, x_hi)


def _shift(s: slice, d: int) -> slice:
    return slice(s.start + d, s.stop + d)


def _to_full(region, geom: PlaneGeom, fill):
    """Pad a (..., Zr, n_bx, Yr, Xr) region array back to the plane shape."""
    zq, yq, xq = _region(geom)
    lead = [(0, 0)] * (region.ndim - 4)
    widths = lead + [(zq.start, geom.pz - zq.stop), (0, 0),
                     (yq.start, geom.py - yq.stop),
                     (xq.start, LANES - xq.stop)]
    return jnp.pad(region, widths, constant_values=fill)


def _region_cells(geom: PlaneGeom):
    """(gx, row, z, interior) int/bool arrays over the query region."""
    zq, yq, xq = _region(geom)
    shape = (zq.stop - zq.start, geom.n_bx, yq.stop - yq.start,
             xq.stop - xq.start)
    z = jax.lax.broadcasted_iota(jnp.int32, shape, 0) + zq.start
    xo = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    row = jax.lax.broadcasted_iota(jnp.int32, shape, 2) + yq.start
    lane = jax.lax.broadcasted_iota(jnp.int32, shape, 3) + xq.start
    gx = xo * TILE_X + lane - 1
    interior = (lane >= 1) & (lane <= TILE_X) & (gx < geom.nx)
    return gx, row, z, interior


def _plain_loop(src, n_acc: int, geom: PlaneGeom, pair, q_shape):
    """sum over source ranks (fori_loop) and the 3^d stencil (unrolled) of
    pair(cand, acc); ``src`` (C, K, pz, n_bx, py, 128) candidate channels."""
    zq, yq, xq = _region(geom)

    def body(k2, acc):
        sk = jax.lax.dynamic_index_in_dim(src, k2, axis=1, keepdims=False)
        for dz in _dzs(geom.dim):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    c = sk[:, _shift(zq, dz), :, _shift(yq, dy),
                           _shift(xq, dx)]
                    acc = pair(c, acc)
        return acc

    acc0 = tuple(jnp.zeros(q_shape, jnp.float32) for _ in range(n_acc))
    return jax.lax.fori_loop(0, geom.k, body, acc0)


def _plain_query(planes, geom: PlaneGeom):
    zq, yq, xq = _region(geom)
    return planes[..., zq, :, yq, xq]


def _density_plain(pos_planes, params: SimParams, geom: PlaneGeom):
    q = _plain_query(pos_planes, geom)                 # (3, K, Zr, ...)
    h2 = params.h * params.h
    (acc,) = _plain_loop(
        pos_planes, 1, geom,
        lambda c, a: (_density_pair(q, c[:, None], a[0], h2, params.dim),),
        q.shape[1:])
    valid = q[0] < pm.SENTINEL * 0.5
    c_poly6 = kernels.poly6_coef(params.h, params.dim) * params.particle_mass
    return _to_full(jnp.where(valid, c_poly6 * acc, 0.0), geom, 0.0)


def _accel_plain(field_planes, rho_planes, params, geom, fuse_integrate,
                 wall_params, emit_movers, slab, continuity):
    fm = _ForceMath(params, continuity)
    eos = fold_eos(field_planes, rho_planes, params)
    src = jnp.concatenate([field_planes, eos], axis=0)       # (8, K, ...)
    qs = _plain_query(src, geom)
    rho_q = _plain_query(rho_planes, geom)
    q = list(qs)
    if fm.use_delta:
        q.append(rho_q * fm.kappa_over_mv)
    acc = _plain_loop(src, fm.n_acc, geom,
                      lambda c, a: fm.pair(q, list(c[:, None]), a),
                      qs.shape[1:])
    out = fm.finish(q, acc)
    valid = q[0] < pm.SENTINEL * 0.5
    if not fuse_integrate:
        res = [jnp.where(valid, o, 0.0) for o in out[:3]]
        fills = [0.0] * 3
    else:
        gx, row, z, interior = _region_cells(geom)
        slab = _default_slab(params, slab)
        res = fm.epilogue(q, out, rho_q, (gx, row, z), interior,
                          (slab[0], slab[1]), wall_params, emit_movers)
        fills = [pm.SENTINEL] * 3 + [0.0] * (len(res) - 3)
    return jnp.stack([_to_full(r, geom, f) for r, f in zip(res, fills)])


# --------------------------------------------------------------------------
# Triton kernel
# --------------------------------------------------------------------------

def _block_origin(geom: PlaneGeom, rows: int):
    """Program ids -> (block index, flat offset of the block in a rank,
    plane z) for the (nzq, n_bx, nyq) query grid."""
    iz, ix, iy = pl.program_id(0), pl.program_id(1), pl.program_id(2)
    nyq = geom.n_by * ROWS_PER_BLOCK // rows
    z = iz + 1 if geom.dim == 3 else iz
    bidx = (iz * geom.n_bx + ix) * nyq + iy
    row0 = ROWS_PER_BLOCK + iy * rows
    base = ((z * geom.n_bx + ix) * geom.py + row0) * LANES
    return bidx, base, z, ix, row0


def _stencil_offsets(geom: PlaneGeom):
    zs = geom.n_bx * geom.py * LANES
    return [[dz * zs + dy * LANES + dx for dy in (-1, 0, 1)
             for dx in (-1, 0, 1)] for dz in _dzs(geom.dim)]


def _density_kernel(occ_q_ref, occ_s_ref, pos_ref, rho_ref, *,
                    params: SimParams, geom: PlaneGeom, rows: int):
    blk = rows * LANES
    bidx, base, _, _, _ = _block_origin(geom, rows)
    offs = _stencil_offsets(geom)
    dim = params.dim
    h2 = params.h * params.h
    c_poly6 = kernels.poly6_coef(params.h, dim) * params.particle_mass
    occ_q = occ_q_ref[bidx]

    def q_loop(k1, _):
        q = [pos_ref[j, k1, pl.ds(base, blk)] for j in range(dim)]
        acc = jnp.zeros((blk,), jnp.float32)
        for zi, zoffs in enumerate(offs):
            def c_loop(k2, acc, zoffs=zoffs):
                for off in zoffs:
                    c = [pos_ref[j, k2, pl.ds(base + off, blk)]
                         for j in range(dim)]
                    acc = _density_pair(q, c, acc, h2, dim)
                return acc
            acc = jax.lax.fori_loop(0, occ_s_ref[bidx * len(offs) + zi],
                                    c_loop, acc)
        valid = q[0] < pm.SENTINEL * 0.5
        rho_ref[k1, pl.ds(base, blk)] = jnp.where(valid, c_poly6 * acc, 0.0)

    jax.lax.fori_loop(0, occ_q, q_loop, None)

    def fill(k1, _):
        rho_ref[k1, pl.ds(base, blk)] = jnp.zeros((blk,), jnp.float32)

    jax.lax.fori_loop(occ_q, geom.k, fill, None)


def _force_kernel(occ_q_ref, occ_s_ref, slab_ref, f6_ref, eos_ref, rho_ref,
                  out_ref, *, params: SimParams, geom: PlaneGeom, rows: int,
                  fuse_integrate: bool, emit_movers: bool, continuity: bool,
                  wall_params: SimParams):
    blk = rows * LANES
    bidx, base, z, ix, row0 = _block_origin(geom, rows)
    offs = _stencil_offsets(geom)
    fm = _ForceMath(params, continuity)
    occ_q = occ_q_ref[bidx]

    def channels(k, off):
        sl = pl.ds(base + off, blk)
        return ([f6_ref[j, k, sl] for j in range(6)]
                + [eos_ref[j, k, sl] for j in range(2)])

    if fuse_integrate:
        lane_id = jax.lax.broadcasted_iota(jnp.int32, (blk,), 0)
        lane = lane_id % LANES
        gx = ix * TILE_X + lane - 1
        interior = (lane >= 1) & (lane <= TILE_X) & (gx < geom.nx)
        cell_xyz = (gx, row0 + lane_id // LANES, z)
        slab = (slab_ref[0], slab_ref[1])
        fills = [pm.SENTINEL] * 3 + [0.0] * (out_ref.shape[0] - 3)
    else:
        fills = [0.0] * 3

    def q_loop(k1, _):
        q = channels(k1, 0)
        rho_q = rho_ref[k1, pl.ds(base, blk)]
        if fm.use_delta:
            q.append(rho_q * fm.kappa_over_mv)
        acc = tuple(jnp.zeros((blk,), jnp.float32)
                    for _ in range(fm.n_acc))
        for zi, zoffs in enumerate(offs):
            def c_loop(k2, acc, zoffs=zoffs):
                for off in zoffs:
                    acc = fm.pair(q, channels(k2, off), acc)
                return acc
            acc = jax.lax.fori_loop(0, occ_s_ref[bidx * len(offs) + zi],
                                    c_loop, acc)
        out = fm.finish(q, acc)
        if fuse_integrate:
            res = fm.epilogue(q, out, rho_q, cell_xyz, interior, slab,
                              wall_params, emit_movers)
        else:
            valid = q[0] < pm.SENTINEL * 0.5
            res = [jnp.where(valid, o, 0.0) for o in out[:3]]
        for c, v in enumerate(res):
            out_ref[c, k1, pl.ds(base, blk)] = v

    jax.lax.fori_loop(0, occ_q, q_loop, None)

    def fill(k1, _):
        for c, f in enumerate(fills):
            out_ref[c, k1, pl.ds(base, blk)] = jnp.full((blk,), f,
                                                        jnp.float32)

    jax.lax.fori_loop(occ_q, geom.k, fill, None)


def _triton_call(kernel, out_shape, geom: PlaneGeom, rows: int,
                 interpret: bool, num_warps: int, num_stages: int, name: str):
    nzq = geom.nz if geom.dim == 3 else 1
    nyq = geom.n_by * ROWS_PER_BLOCK // rows
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(nzq, geom.n_bx, nyq),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name=name,
    )


def _flat(a, lead: int):
    return a.reshape(a.shape[:lead] + (-1,))


def _density_triton(pos_planes, params, geom, *, rows=None, interpret=False,
                    num_warps=None, num_stages=None):
    rows = rows or DENSITY_LAUNCH[0]
    occ_q, occ_s = pm.occupancy_bounds(pos_planes, params, geom, rows)
    kernel = functools.partial(_density_kernel, params=params, geom=geom,
                               rows=rows)
    shape = (geom.k, geom.pz, geom.n_bx, geom.py, LANES)
    call = _triton_call(
        kernel, jax.ShapeDtypeStruct((geom.k, geom.cells), jnp.float32),
        geom, rows, interpret, num_warps or DENSITY_LAUNCH[1],
        num_stages or DENSITY_LAUNCH[2], "sph_density")
    out = call(occ_q.reshape(-1), occ_s.reshape(-1), _flat(pos_planes, 2))
    return out.reshape(shape)


def _accel_triton(field_planes, rho_planes, params, geom, fuse_integrate,
                  wall_params, emit_movers, slab, continuity, *, rows=None,
                  interpret=False, num_warps=None, num_stages=None):
    rows = rows or FORCE_LAUNCH[0]
    occ_q, occ_s = pm.occupancy_bounds(field_planes, params, geom, rows)
    eos = fold_eos(field_planes, rho_planes, params)
    n_out = _n_out(fuse_integrate, emit_movers, continuity)
    kernel = functools.partial(
        _force_kernel, params=params, geom=geom, rows=rows,
        fuse_integrate=fuse_integrate, emit_movers=emit_movers,
        continuity=continuity, wall_params=wall_params)
    call = _triton_call(
        kernel,
        jax.ShapeDtypeStruct((n_out, geom.k, geom.cells), jnp.float32),
        geom, rows, interpret, num_warps or FORCE_LAUNCH[1],
        num_stages or FORCE_LAUNCH[2], "sph_force")
    out = call(occ_q.reshape(-1), occ_s.reshape(-1),
               _default_slab(params, slab), _flat(field_planes, 2),
               _flat(eos, 2), _flat(rho_planes, 1))
    return out.reshape((n_out,) + rho_planes.shape)


# --------------------------------------------------------------------------
# public sweeps
# --------------------------------------------------------------------------

def density_planes(pos_planes, params: SimParams, geom: PlaneGeom, *,
                   impl: str = None, **triton_kw):
    """(3, K, pz, n_bx, py, 128) position planes -> (K, pz, n_bx, py, 128)
    summation density (0 on empty slots)."""
    if (impl or sweep_impl()) == "triton":
        return _density_triton(pos_planes, params, geom, **triton_kw)
    return _density_plain(pos_planes, params, geom)


def accel_planes(field_planes, rho_planes, params: SimParams,
                 geom: PlaneGeom, fuse_integrate: bool = False,
                 wall_params: SimParams = None, emit_movers: bool = False,
                 slab=None, continuity: bool = False, *, impl: str = None,
                 **triton_kw):
    """(6, K, pz, n_bx, py, 128) pos/vel planes + (K, ...) density planes
    -> (3, K, ...) pressure + viscosity acceleration (gravity NOT included).
    The EOS runs once per step in ``fold_eos``.

    With ``fuse_integrate``: -> (6, K, ...) post-step pos/vel planes
    (gravity, symplectic Euler and collide fused into the sweep).

    With ``emit_movers`` (requires fuse_integrate): -> (new6, flagp) where
    flagp is 1.0 on interior slots whose particle left its cell this step.
    ``slab`` (2,) [binning x-origin, slab end) marks particles leaving the
    device's x slab as movers under spatial sharding.

    With ``continuity`` (requires both): rho_planes is the CARRIED density
    and the return is (new6, rho_new, flagp).
    """
    _n_out(fuse_integrate, emit_movers, continuity)
    if (impl or sweep_impl()) == "triton":
        outs = _accel_triton(field_planes, rho_planes, params, geom,
                             fuse_integrate, wall_params, emit_movers, slab,
                             continuity, **triton_kw)
    else:
        outs = _accel_plain(field_planes, rho_planes, params, geom,
                            fuse_integrate, wall_params, emit_movers, slab,
                            continuity)
    return _split_outputs(outs, fuse_integrate, emit_movers, continuity)


# --------------------------------------------------------------------------
# full step
# --------------------------------------------------------------------------

def step_pallas(pos, vel, ids, params: SimParams, *,
                x_origin=None, active=None, exchange=None,
                wall_params: SimParams = None):
    """One full SPH step on the rank-plane path.

    bin -> (ghost exchange) -> density sweep -> (ghost exchange) -> force
    sweep -> gather -> integrate.  Returns (pos, vel, rho, pres, ids,
    overflow) in CELL-SORTED order (the reference's reorder-for-coalescing
    trick, adopted as canonical order; `ids` carries identity).

    Sharded mode (parallel/sharded.py): ``x_origin`` is the device's domain
    offset, ``active`` masks live capacity slots, and ``exchange(stack,
    pos_fields)`` fills the outermost halo lanes from neighbor devices.
    """
    geom = pm.geometry(params)
    table = pm.build_planes(pos, vel, ids, params, geom,
                            x_origin=x_origin, active=active)
    planes = table.planes
    if exchange is not None:
        planes = exchange(planes, n_pos_fields=pm.N_POS_FIELDS)
    pos_planes = planes[:pm.N_POS_FIELDS]

    rho_p = density_planes(pos_planes, params, geom)
    # halo lanes hold edge-truncated densities; refresh them from the
    # owning tile before the force sweep reads them as candidates
    rho_h = pm.halo_x(rho_p)
    if exchange is not None:
        rho_h = exchange(rho_h[None], n_pos_fields=0)[0]
    acc_p = accel_planes(planes, rho_h, params, geom)

    if params.diagnostics:
        valid = pos_planes[0] < pm.SENTINEL * 0.5
        rho_d = jnp.maximum(jnp.where(valid, rho_p, params.rest_density),
                            1e-3 * params.rest_density)
        pres_p = physics.eos_pressure(rho_d, params)
        stack = jnp.concatenate([acc_p, rho_d[None], pres_p[None]], axis=0)
    else:
        stack = acc_p
    out = pm.gather_slots(stack, table.slot, table.ok, 0.0)
    grav = jnp.asarray(params.gravity + (0.0,) * (3 - params.dim),
                       jnp.float32)
    acc = out[:, :3] + grav                 # dropped rows: 0 + grav = grav
    acc = acc[:, :params.dim]
    if params.diagnostics:
        rho = jnp.where(table.ok, out[:, 3], params.rest_density)
        pres = jnp.where(table.ok, out[:, 4], 0.0)
    else:
        rho = jnp.full(acc.shape[:1], params.rest_density, jnp.float32)
        pres = jnp.zeros(acc.shape[:1], jnp.float32)

    if active is not None:
        active_s = table.ids_s >= 0
        acc = jnp.where(active_s[:, None], acc, 0.0)

    # walls/obstacles may differ from the binning grid (sharded mode: the
    # grid covers one slab but the walls are the global domain)
    pos, vel = physics.integrate(table.pos_s, table.vel_s, acc,
                                 wall_params or params)
    if active is not None:
        # keep inactive slots parked at the sentinel position
        pos = jnp.where(active_s[:, None], pos, pm.SENTINEL)
        vel = jnp.where(active_s[:, None], vel, 0.0)
    return pos, vel, rho, pres, table.ids_s, table.overflow
